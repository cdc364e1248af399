// Flash-decode attention for Hopper (sm_90a): one query token per row
// against a long KV cache, with a float (float32 or bfloat16) cache or an
// int8 cache with float32 scales per (batch, kv head, position).
//
// Replaces the Pallas TPU kernels `_decode_kernel` and `_decode_kernel_int8`
// (src/repro/kernels/decode_attention/kernel.py) behind
// `decode_attention_grouped`, `decode_attention_grouped_cache`,
// `decode_attention_int8_grouped` and `decode_attention_int8_grouped_cache`.
// q is [B, KV, G, D]: the G query heads that share kv head `kv`.  Row b
// attends to the cache positions 0..cur_index[b], an int32 vector on the
// card, so one launch serves a lockstep batch (every entry equal) and a slot
// batch of continuous serving (one position per row) alike.  The scores and
// the softmax are float32; the scale is D^-0.5, applied to q in float32;
// the output has q's type.  int8: the k scale multiplies the scores and the
// v scale the probabilities before the PV product, as `_decode_kernel_int8`
// does, so no dequantized block is ever formed.
//
// The cache is read through its strides (batch, kv head, position; the
// head dimension contiguous), so the same kernel reads the serving layout
// [B, KV, S, D] and the kernel-native layout [B, S, KV, D] in place: the
// wrapper transposes, copies and pads nothing.
//
// What bounds it on an H100: each cache element is read once and used for
// 2G multiply-adds, far below the ~20 float32 operations per byte where the
// FMA pipe would take over, so the cache's bytes bound it (3.35 TB/s).  A
// serving batch has few (b, kv) pairs (8 x 8 = 64 against 132 SMs), so the
// TPU grid's sequential kv axis becomes split-K: one block per (b, kv head,
// group tile, chunk of CHUNK positions), each writing an unnormalised
// partial (acc, m, l) for its chunk, and a second small kernel that combines
// the chunks of each row.  Chunks past cur_index[b] exit at once.  CHUNK is
// fixed, so the summation order of a row depends on its own cur_index only,
// never on the batch it shares a launch with.
//
// Inside a block, LANES = D / VEC threads share a cache row, each loading
// one 8- or 16-byte vector (VEC elements), and the block keeps U rows per
// thread in flight; the G query rows stay in registers.  Scores and then
// probabilities for the chunk sit in shared memory between the two passes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;          // threads per block: 4 warps
constexpr int NW = NT / 32;
constexpr int CHUNK = 256;       // cache positions per split block
constexpr int U = 4;             // cache rows a thread keeps in flight
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One vector load of a cache row's slice, converted to float32.
template <typename T> struct Vec;
template <> struct Vec<float> {          // 16 bytes
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  }
};
template <> struct Vec<__nv_bfloat16> {  // 16 bytes
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<int8_t> {         // 8 bytes
  static constexpr int N = 8;
  __device__ static void load(const int8_t* p, float* out) {
    const int2 t = *reinterpret_cast<const int2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&t);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
  }
};

template <int W>
__device__ __forceinline__ float sum_lanes(float x) {  // over aligned groups of W lanes
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pass 1: one block per (chunk, kv head x group tile, batch row).  Writes
// the chunk's unnormalised output acc[D] and its (m, l) for each of its GT
// query rows.  ks/vs are null for a float cache.
template <typename QT, typename KT, int D, int GT>
__global__ void __launch_bounds__(NT)
decode_split(const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ cur_index, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int KV, int G, int S, long long sb,
             long long skv, long long ss, int n_split, float scale) {
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  constexpr int VEC = Vec<KT>::N;
  constexpr int LANES = D / VEC;   // threads per cache row
  constexpr int ROWS = NT / LANES; // cache rows per block-wide step
  static_assert(LANES >= 1 && LANES <= 32 && 32 % LANES == 0, "row split");
  static_assert(GT <= NW, "one warp per query row in the softmax pass");

  __shared__ float s_p[GT][CHUNK];        // scores, then probabilities
  __shared__ float s_red[NW][GT][D];      // per-warp partial outputs
  __shared__ float s_ml[GT][2];

  const int split = blockIdx.x;
  const int n_gt = (G + GT - 1) / GT;
  const int kvh = blockIdx.y / n_gt;
  const int g0 = (blockIdx.y % n_gt) * GT;
  const int b = blockIdx.z;
  const int cur = min(cur_index[b], S - 1);
  const int start = split * CHUNK;
  if (start > cur) return;  // past the valid prefix: the combine skips it
  const int n = min(CHUNK, cur + 1 - start);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int col = tid % LANES;   // which VEC-wide slice of the row
  const int row = tid / LANES;   // which row of a block-wide step
  const int d0 = col * VEC;

  float qr[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const bool ok = g0 + g < G;
    const QT* qp = q + (((size_t)b * KV + kvh) * G + (ok ? g0 + g : 0)) * D + d0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[g][e] = ok ? to_f32(qp[e]) * scale : 0.f;
  }
  const KT* kb = k + b * sb + kvh * skv + (long long)start * ss + d0;
  const KT* vb = v + b * sb + kvh * skv + (long long)start * ss + d0;
  const float* ksb = kInt8 ? ks + ((size_t)b * KV + kvh) * S + start : nullptr;
  const float* vsb = kInt8 ? vs + ((size_t)b * KV + kvh) * S + start : nullptr;

  // 1. scores of this chunk's rows; every lane runs every step, so the
  //    shuffles see whole warps
  for (int base = 0; base < n; base += ROWS * U) {
    float kr[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * ROWS + row;
      if (i < n) {
        Vec<KT>::load(kb + (long long)i * ss, kr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * ROWS + row;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[g][e], kr[u][e], dot);
        dot = sum_lanes<LANES>(dot);
        if (col == 0 && i < n) s_p[g][i] = kInt8 ? dot * ksb[i] : dot;
      }
    }
  }
  __syncthreads();

  // 2. the chunk's softmax, warp g for query row g: m, l of the unscaled
  //    probabilities; int8 folds the v scale into the stored probabilities
  if (warp < GT) {
    float m = NEG_INF;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, s_p[warp][i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(s_p[warp][i] - m);
      l += p;
      s_p[warp][i] = kInt8 ? p * vsb[i] : p;
    }
    l = sum_lanes<32>(l);
    if (lane == 0) {
      s_ml[warp][0] = m;
      s_ml[warp][1] = l;
    }
  }
  __syncthreads();

  // 3. acc[g][d] = sum_i p[g][i] * v[i][d] over this thread's rows
  float acc[GT][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  for (int base = 0; base < n; base += ROWS * U) {
    float vr[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * ROWS + row;
      if (i < n) {
        Vec<KT>::load(vb + (long long)i * ss, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * ROWS + row;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = i < n ? s_p[g][i] : 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
      }
    }
  }
  // sum over the rows a warp holds, then over the warps
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float x = acc[g][e];
#pragma unroll
      for (int o = LANES; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      acc[g][e] = x;
    }
  if (lane < LANES) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_red[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = tid; idx < GT * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    if (g0 + g >= G) continue;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) x += s_red[w][g][d];
    const size_t r = ((size_t)b * KV + kvh) * G + g0 + g;
    part_acc[(r * n_split + split) * D + d] = x;
    if (d < 2) part_ml[(r * n_split + split) * 2 + d] = s_ml[g][d];
  }
}

// Pass 2: one block of D threads per query row combines the chunks up to
// cur_index[b]: out = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M).
template <typename OT>
__global__ void decode_combine(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               const int* __restrict__ cur_index, OT* __restrict__ out,
                               int rows_per_b, int S, int D, int n_split) {
  const size_t r = blockIdx.x;
  const int d = threadIdx.x;
  const int cur = min(cur_index[r / rows_per_b], S - 1);
  if (cur < 0) {  // no valid position: zeros, as the TPU kernel gives
    store(out + r * D + d, 0.f);
    return;
  }
  const int nv = cur / CHUNK + 1;
  const float* ml = part_ml + r * n_split * 2;
  float m = NEG_INF;
  for (int j = 0; j < nv; ++j) m = fmaxf(m, ml[2 * j]);
  float l = 0.f, acc = 0.f;
  for (int j = 0; j < nv; ++j) {
    const float w = expf(ml[2 * j] - m);
    l = fmaf(ml[2 * j + 1], w, l);
    acc = fmaf(part_acc[(r * n_split + j) * D + d], w, acc);
  }
  store(out + r * D + d, acc / fmaxf(l, 1e-30f));
}

template <typename QT, typename KT, int D, int GT>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* cur, void* out, float* part_acc,
                   float* part_ml, int B, int KV, int G, int S, long long sb,
                   long long skv, long long ss, float scale, cudaStream_t stream) {
  const int n_split = (S + CHUNK - 1) / CHUNK;
  const int n_gt = (G + GT - 1) / GT;
  dim3 grid(n_split, KV * n_gt, B);
  decode_split<QT, KT, D, GT><<<grid, NT, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      ks, vs, cur, part_acc, part_ml, KV, G, S, sb, skv, ss, n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<QT><<<B * KV * G, D, 0, stream>>>(
      part_acc, part_ml, cur, static_cast<QT*>(out), KV * G, S, D, n_split);
  return cudaGetLastError();
}

template <typename QT, typename KT, int D>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const int* cur, void* out, float* part_acc,
                     float* part_ml, int B, int KV, int S, long long sb, long long skv,
                     long long ss, float scale, cudaStream_t stream) {
  if (G <= 2)
    return launch<QT, KT, D, 2>(q, k, v, ks, vs, cur, out, part_acc, part_ml, B, KV, G,
                                S, sb, skv, ss, scale, stream);
  return launch<QT, KT, D, 4>(q, k, v, ks, vs, cur, out, part_acc, part_ml, B, KV, G, S,
                              sb, skv, ss, scale, stream);
}

template <typename QT, typename KT>
cudaError_t launch_d(int D, int G, const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* cur, void* out,
                     float* part_acc, float* part_ml, int B, int KV, int S, long long sb,
                     long long skv, long long ss, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_g<QT, KT, 32>(G, q, k, v, ks, vs, cur, out, part_acc, part_ml,
                                         B, KV, S, sb, skv, ss, scale, stream);
    case 64: return launch_g<QT, KT, 64>(G, q, k, v, ks, vs, cur, out, part_acc, part_ml,
                                         B, KV, S, sb, skv, ss, scale, stream);
    case 128: return launch_g<QT, KT, 128>(G, q, k, v, ks, vs, cur, out, part_acc,
                                           part_ml, B, KV, S, sb, skv, ss, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, bound with ctypes.  dtype codes: 0 float32, 1 bfloat16.
// Strides are in elements; part_acc holds B*KV*G*ceil(S/CHUNK)*D floats and
// part_ml B*KV*G*ceil(S/CHUNK)*2.  Return a cudaError_t; 0 on success.
extern "C" int repro_decode_attention_chunk() { return CHUNK; }

extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* cur, void* out, float* part_acc,
                                      float* part_ml, int B, int KV, int G, int S, int D,
                                      long long sb, long long skv, long long ss,
                                      int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float, float>(D, G, q, k, v, nullptr, nullptr, cur, out, part_acc,
                                  part_ml, B, KV, S, sb, skv, ss, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, G, q, k, v, nullptr, nullptr, cur,
                                                  out, part_acc, part_ml, B, KV, S, sb,
                                                  skv, ss, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int repro_decode_attention_int8(const void* q, const void* k, const void* v,
                                           const float* ks, const float* vs,
                                           const int* cur, void* out, float* part_acc,
                                           float* part_ml, int B, int KV, int G, int S,
                                           int D, long long sb, long long skv,
                                           long long ss, int q_dtype, float scale,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_d<float, int8_t>(D, G, q, k, v, ks, vs, cur, out, part_acc, part_ml, B,
                                   KV, S, sb, skv, ss, scale, st);
  if (q_dtype == 1)
    return launch_d<__nv_bfloat16, int8_t>(D, G, q, k, v, ks, vs, cur, out, part_acc,
                                           part_ml, B, KV, S, sb, skv, ss, scale, st);
  return cudaErrorInvalidValue;
}
