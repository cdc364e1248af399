// Flash attention forward for Hopper (sm_90a), float32 in and out and inside.
// The bfloat16 route is its own kernel, on the tensor cores, in
// flash_attention_bf16.cu.
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/kernel.py):
// online-softmax attention with the running max m, running sum l and the
// output accumulator kept in float32, native GQA (kv head = q head / group),
// causal masking when Sq == Sk, and masking of the ragged key tail.
//
// Layout: q and o are [B, Sq, H, D], k and v are [B, Sk, KV, D], all
// contiguous, so the kernel reads the model's layout directly and the
// wrapper transposes and pads nothing.  Rows past Sq are never written and
// keys past Sk are masked inside the kernel.
//
// Design: one block of 256 threads per (b*h, tile of 64 query rows).  The
// scaled Q tile stays in shared memory for the whole kv loop; each K/V tile
// of 64 keys is staged through shared memory (K transposed, so the score
// loop reads 16-byte vectors).  A thread owns 4 query rows x 4 keys of the
// score tile and 4 rows x D/16 columns of the output, so m, l and the
// accumulator live in registers.  The probability tile reuses the K tile's
// shared memory, which keeps a D = 128 block at about 100 KB and lets two
// blocks share an SM.
//
// What bounds it on an H100: at the DiT's shapes (S = 18,900, D = 128) the
// work is 4*S^2*D flops per head against 4*S*D*4 bytes of input and output,
// so operations bound it.  This first version computes with float32 FMAs
// outside the tensor cores (67 TFLOP/s peak), not with wgmma on tf32; the
// register tiling above is what it does to stay near the FMA pipe rather
// than the shared-memory pipe.  Moving to the tensor cores with TMA-fed
// tiles, at float32 accuracy, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int RQ = BQ / 16;   // query rows per thread (strided by 16)
constexpr int RK = BK / 16;   // keys per thread (4 contiguous)
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  static constexpr int NV = D / 16;            // output columns per thread
  static constexpr int VW = NV >= 4 ? 4 : NV;  // vector width of a column group
  static constexpr int QS = D + 4;             // row strides in floats; +4 keeps
  static constexpr int KS = BK + 4;            // 16-byte alignment and spreads
  static constexpr int PS = BK + 4;            // rows over the banks
  static constexpr int VS = D;
  static constexpr int KP = (D * KS > BQ * PS) ? D * KS : BQ * PS;  // K^T or P
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BQ * QS;
  static constexpr int v_off = k_off + KP;
  static constexpr int floats = v_off + BK * VS;
  static constexpr size_t bytes = floats * sizeof(float);
  // column of the output owned by thread tx in slot n
  __device__ static int col(int tx, int n) {
    return (n / VW) * (16 * VW) + tx * VW + (n % VW);
  }
};

template <int W>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (W == 4) {
    float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (W == 2) {
    float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) dst[e] = src[e];
  }
}

// Four consecutive elements of a row (16 bytes).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          int H, int KV, int Sq, int Sk, int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + L::q_off;   // [BQ][QS], pre-scaled
  float* Kt = smem + L::k_off;   // [D][KS]  (K transposed) ...
  float* Ps = smem + L::k_off;   // ... or [BQ][PS] probabilities, same memory
  float* Vs = smem + L::v_off;   // [BK][VS]

  const int tid = threadIdx.x;
  const int tx = tid % 16;       // key / output-column group
  const int ty = tid / 16;       // query row group: rows ty + 16*i
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);  // native GQA: no repeated K/V
  const int q0 = blockIdx.x * BQ;

  const size_t q_row = (size_t)H * D;
  const size_t k_row = (size_t)KV * D;
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * k_row + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Sk * k_row + (size_t)kvh * D;
  T* ob = o + (size_t)b * Sq * q_row + (size_t)h * D;

  constexpr int D4 = D / 4;
  for (int idx = tid; idx < BQ * D4; idx += NT) {
    const int r = idx / D4, d = (idx % D4) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) t = load4(qb + (size_t)(q0 + r) * q_row + d);
    t.x *= scale; t.y *= scale; t.z *= scale; t.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * L::QS + d) = t;
  }

  float m[RQ], l[RQ], acc[RQ][L::NV];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < L::NV; ++n) acc[i][n] = 0.f;
  }

  // causal: tiles past this block's last query row hold only masked keys
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's P and V reads are done
    for (int idx = tid; idx < BK * D4; idx += NT) {
      // consecutive threads take consecutive keys: conflict-free transposed stores
      const int c = idx % BK, d = (idx / BK) * 4;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < Sk) t = load4(kb + (size_t)(k0 + c) * k_row + d);
      Kt[(d + 0) * L::KS + c] = t.x;
      Kt[(d + 1) * L::KS + c] = t.y;
      Kt[(d + 2) * L::KS + c] = t.z;
      Kt[(d + 3) * L::KS + c] = t.w;
    }
    for (int idx = tid; idx < BK * D4; idx += NT) {
      const int c = idx / D4, d = (idx % D4) * 4;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < Sk) t = load4(vb + (size_t)(k0 + c) * k_row + d);
      *reinterpret_cast<float4*>(Vs + c * L::VS + d) = t;
    }
    __syncthreads();

    // scores s[i][j] = (scale*q_row) . k_col for rows ty+16i, keys 4tx+j
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qr[RQ][4], kr[4][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) load_vec<4>(Qs + (ty + 16 * i) * L::QS + d, qr[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) load_vec<4>(Kt + (d + e) * L::KS + tx * RK, kr[e]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qr[i][e], kr[e][j], s[i][j]);
    }

    // online softmax, row by row; the 16 threads of a half-warp share a row
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx * RK + j;
        if (kpos >= Sk || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(fmaxf(m[i], mx), -1e29f);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      l[i] = l[i] * corr + ps;  // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < L::NV; ++n) acc[i][n] *= corr;
    }
    __syncthreads();  // every thread is done reading K^T: P takes its place
#pragma unroll
    for (int i = 0; i < RQ; ++i)
      *reinterpret_cast<float4*>(Ps + (ty + 16 * i) * L::PS + tx * RK) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();

    // acc += P @ V
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[RQ], vr[L::NV];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pr[i] = Ps[(ty + 16 * i) * L::PS + c];
#pragma unroll
      for (int g = 0; g < L::NV / L::VW; ++g)
        load_vec<L::VW>(Vs + c * L::VS + g * 16 * L::VW + tx * L::VW, vr + g * L::VW);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int n = 0; n < L::NV; ++n) acc[i][n] = fmaf(pr[i], vr[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float inv = 1.f / fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int qpos = q0 + ty + 16 * i;
    if (qpos < Sq) {
      T* orow = ob + (size_t)qpos * q_row;
#pragma unroll
      for (int n = 0; n < L::NV; ++n) store1(orow + L::col(tx, n), acc[i][n] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, T* o,
                   int B, int H, int KV, int Sq, int Sk, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd<T, D><<<grid, NT, bytes, stream>>>(q, k, v, o, H, KV, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int KV, int Sq, int Sk, int D, int causal, float scale,
                     void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<T, 32>(qt, kt, vt, ot, B, H, KV, Sq, Sk, causal, scale, s);
    case 64: return launch<T, 64>(qt, kt, vt, ot, B, H, KV, Sq, Sk, causal, scale, s);
    case 128: return launch<T, 128>(qt, kt, vt, ot, B, H, KV, Sq, Sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes.  Returns a cudaError_t; 0 on success.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                                         void* o, int B, int H, int KV, int Sq, int Sk,
                                         int D, int causal, float scale, void* stream) {
  return launch_d<float>(q, k, v, o, B, H, KV, Sq, Sk, D, causal, scale, stream);
}
