// Flash attention backward on Hopper (sm_90a) in float32, on the CUDA cores.
//
// The gradient of the float32 forward kernel in flash_attention.cu, which
// replaces the float32 route of the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:36).  The TPU kernel has no
// backward: the JAX package trains with its plain attention and takes the
// gradient by autodiff.  This kernel computes that same gradient, so that a
// loss built through the forward kernel differentiates through a kernel too
// (the port picks the path by the tensor's device, with no switch to the
// plain attention).  It is a new kernel, not a port.  This file holds only
// the float32 instantiations; the bfloat16 gradient runs on the tensor cores
// in flash_attention_bwd_bf16.cu.
//
// Layout as the forward: q, o, dO, dq are [B, Sq, H, D], k, v, dk, dv are
// [B, Sk, KV, D], contiguous, D in {32, 64, 128}; GQA without repeats (query
// head h reads kv head h / (H / KV)); causal masks key j > query i (Sq ==
// Sk); keys past Sk and rows past Sq are masked, nothing is padded.
//
// With s = scale q.k, P = softmax(s) and delta_i = sum_d dO_id o_id:
//   dS = P (dO V^T - delta),  dq = scale dS K,  dk = scale dS^T Q,  dv = P^T dO,
// dk and dv of a kv head summed over its group of query heads.
//
// Design, simple and deterministic first (no atomics: two runs give equal
// bits).  Three kernels, 256 threads a block, tiles of 64 query rows and 64
// keys held in shared memory (rows padded to D + 1 floats); everything
// accumulates in float32 on the CUDA cores:
//   1. bwd_stats, one block per (b, h, query tile): recomputes each row's
//      log-sum-exp over the keys (online, as the forward) and its delta, so
//      the tuned forward kernels stay as they are;
//   2. bwd_dkdv, one block per (b, kv head, key tile): K and V stay in
//      shared memory while the block loops over the query heads of its
//      group and over their query tiles (causal: from the tile that holds
//      its first key), accumulating dk and dv in registers;
//   3. bwd_dq, one block per (b, h, query tile): loops over the key tiles
//      (causal: up to the diagonal), accumulating dq in registers.
// A thread owns query rows (or keys) ty + 16 i and columns tx + 16 j of a
// tile (tx, ty in 0..15), so that the 16 threads of a half warp read 16
// neighbouring floats.
//
// What bounds it on an H100: the work is 10 Sq Sk D flops a head (half of
// it causal) on 8 tensors' bytes, far above the card's 295 flops a byte, so
// operations; on the CUDA cores, with two shared-memory loads for each pair
// of FMAs, it runs well below even the 67 TFLOP/s float32 rate.  Moving the
// products onto 3xTF32 `wgmma` and taking the log-sum-exp from the forward
// are the redesign's work, as flash_attention_bwd_bf16.cu did for bfloat16.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // threads a block, 16 x 16
constexpr int R = 4;     // rows (keys) a thread: ty + 16 i
constexpr int C = 4;     // score columns a thread: tx + 16 j
constexpr int PS = BK + 1;  // row pitch of a score tile

// Rows [r0, r0 + 64) of one head of a [B, S, NH, D] tensor (``src`` at
// [b, 0, head, 0], ``pitch`` = NH D elements) into a [64][D + 1] float tile,
// zeros past S.
template <int D>
__device__ void load_tile(float* dst, const float* src, int r0, int S, size_t pitch) {
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (r0 + r < S) ? src[(size_t)(r0 + r) * pitch + c] : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two [64][D + 1] tiles.
template <int D>
__device__ __forceinline__ void dots(const float* A, const float* B, float (&acc)[R][C]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[R], b[C];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < C; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Sum and max over the 16 threads of a half warp that share a row.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ bool live(int qi, int kj, int Sq, int Sk, int causal) {
  return qi < Sq && kj < Sk && (!causal || kj <= qi);
}

// P and dS of one (query tile, key tile) pair into shared memory, from the
// Q, dO, K, V tiles and the rows' log-sum-exp and delta.
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, const float* lse, const float* delta,
                                       float* Ps, float* dSs, int q0, int k0, int Sq, int Sk,
                                       int causal, float scale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[R][C], dp[R][C];
  dots<D>(Qs, Ks, s);
  dots<D>(dOs, Vs, dp);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = tx + 16 * j;
      const float p = live(q0 + r, k0 + c, Sq, Sk, causal)
                          ? expf(s[i][j] * scale - lse[r]) : 0.f;
      if (Ps) Ps[r * PS + c] = p;
      dSs[r * PS + c] = p * (dp[i][j] - delta[r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) bwd_stats(const float* __restrict__ q,
                                                const float* __restrict__ k,
                                                const float* __restrict__ o,
                                                const float* __restrict__ dout,
                                                float* __restrict__ lse, float* __restrict__ delta,
                                                int H, int KV, int Sq, int Sk, int causal,
                                                float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (D + 1);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qpitch = (size_t)H * D, kpitch = (size_t)KV * D;
  const size_t qbase = (size_t)b * Sq * H * D + (size_t)h * D;
  load_tile<D>(Qs, q + qbase, q0, Sq, qpitch);

  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = -INFINITY, l[i] = 0.f;
  const int n_kt = causal ? blockIdx.y + 1 : (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D>(Ks, k + (size_t)b * Sk * KV * D + (size_t)kvh * D, k0, Sk, kpitch);
    __syncthreads();
    float s[R][C];
    dots<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        s[i][j] = live(q0 + ty + 16 * i, k0 + tx + 16 * j, Sq, Sk, causal)
                      ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) sum += expf(s[i][j] - mn);
      sum = row_sum(sum);
      if (mn != -INFINITY) {  // a row with no live key in this tile keeps its state
        l[i] = l[i] * expf(m[i] - mn) + sum;
        m[i] = mn;
      }
    }
  }
  const size_t row0 = (size_t)bh * Sq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + 16 * i;
    float dd = 0.f;
    if (r < Sq)
      for (int c = tx; c < D; c += 16)
        dd = fmaf(dout[qbase + (size_t)r * qpitch + c],
                  o[qbase + (size_t)r * qpitch + c], dd);
    dd = row_sum(dd);
    if (tx == 0 && r < Sq) {
      lse[row0 + r] = m[i] + logf(l[i]);
      delta[row0 + r] = dd;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) bwd_dkdv(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v,
                                               const float* __restrict__ dout,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               float* __restrict__ dk, float* __restrict__ dv,
                                               int H, int KV, int Sq, int Sk,
                                               int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int TILE = BQ * (D + 1);
  constexpr int J = D / 16;  // output columns a thread: tx + 16 j
  float* Ks = smem;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;
  float* dOs = Qs + TILE;
  float* Ps = dOs + TILE;
  float* dSs = Ps + BQ * PS;
  float* lse_s = dSs + BQ * PS;
  float* delta_s = lse_s + BQ;
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV, G = H / KV;
  const int k0 = blockIdx.y * BK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qpitch = (size_t)H * D, kpitch = (size_t)KV * D;
  const size_t kbase = (size_t)b * Sk * KV * D + (size_t)kvh * D;
  load_tile<D>(Ks, k + kbase, k0, Sk, kpitch);
  load_tile<D>(Vs, v + kbase, k0, Sk, kpitch);

  float dK[R][J], dV[R][J];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) dK[i][j] = 0.f, dV[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qbase = (size_t)b * Sq * H * D + (size_t)h * D;
    const size_t row0 = ((size_t)b * H + h) * Sq;
    for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(Qs, q + qbase, q0, Sq, qpitch);
      load_tile<D>(dOs, dout + qbase, q0, Sq, qpitch);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        lse_s[r] = q0 + r < Sq ? lse[row0 + q0 + r] : 0.f;
        delta_s[r] = q0 + r < Sq ? delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();
      scores<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq, Sk, causal, scale);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[R], ds[R], dov[J], qv[J];
#pragma unroll
        for (int i = 0; i < R; ++i) p[i] = Ps[r * PS + ty + 16 * i], ds[i] = dSs[r * PS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < J; ++j)
          dov[j] = dOs[r * (D + 1) + tx + 16 * j], qv[j] = Qs[r * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < J; ++j) {
            dV[i][j] = fmaf(p[i], dov[j], dV[i][j]);
            dK[i][j] = fmaf(ds[i], qv[j], dK[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t at = kbase + (size_t)key * kpitch + tx + 16 * j;
      dk[at] = dK[i][j] * scale;
      dv[at] = dV[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) bwd_dq(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             float* __restrict__ dq,
                                             int H, int KV, int Sq, int Sk, int causal,
                                             float scale) {
  extern __shared__ float smem[];
  constexpr int TILE = BQ * (D + 1);
  constexpr int J = D / 16;
  float* Qs = smem;
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;
  float* Vs = Ks + TILE;
  float* dSs = Vs + TILE;
  float* lse_s = dSs + BQ * PS;
  float* delta_s = lse_s + BQ;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qpitch = (size_t)H * D, kpitch = (size_t)KV * D;
  const size_t qbase = (size_t)b * Sq * H * D + (size_t)h * D;
  const size_t kbase = (size_t)b * Sk * KV * D + (size_t)kvh * D;
  const size_t row0 = (size_t)bh * Sq;
  load_tile<D>(Qs, q + qbase, q0, Sq, qpitch);
  load_tile<D>(dOs, dout + qbase, q0, Sq, qpitch);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    lse_s[r] = q0 + r < Sq ? lse[row0 + q0 + r] : 0.f;
    delta_s[r] = q0 + r < Sq ? delta[row0 + q0 + r] : 0.f;
  }

  float dQ[R][J];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) dQ[i][j] = 0.f;
  const int n_kt = causal ? blockIdx.y + 1 : (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D>(Ks, k + kbase, k0, Sk, kpitch);
    load_tile<D>(Vs, v + kbase, k0, Sk, kpitch);
    __syncthreads();
    scores<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0, k0, Sq, Sk, causal, scale);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[R], kv[J];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < J; ++j) kv[j] = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) dQ[i][j] = fmaf(ds[i], kv[j], dQ[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < J; ++j)
      dq[qbase + (size_t)r * qpitch + tx + 16 * j] = dQ[i][j] * scale;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, float* dq, float* dk, float* dv, float* lse, float* delta,
                   int B, int H, int KV, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t tile = (size_t)BQ * (D + 1), score_tile = (size_t)BQ * PS;
  constexpr size_t stats_bytes = 2 * tile * 4;
  constexpr size_t dkdv_bytes = (4 * tile + 2 * score_tile + 2 * BQ) * 4;
  constexpr size_t dq_bytes = (4 * tile + score_tile + 2 * BQ) * 4;
  const unsigned q_tiles = (Sq + BQ - 1) / BQ, k_tiles = (Sk + BK - 1) / BK;
  if (q_tiles > 65535u || k_tiles > 65535u || H % KV) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bwd_stats<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)stats_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_bytes);
  if (err != cudaSuccess) return err;
  bwd_stats<D><<<dim3(B * H, q_tiles), NT, stats_bytes, stream>>>(
      q, k, o, dout, lse, delta, H, KV, Sq, Sk, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkdv<D><<<dim3(B * KV, k_tiles), NT, dkdv_bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, KV, Sq, Sk, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dq<D><<<dim3(B * H, q_tiles), NT, dq_bytes, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KV, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes: dq, dk, dv from q, k, v, the forward's
// output o and its gradient dout, all float32; lse and delta are float32
// scratch of B H Sq elements each.  Returns a cudaError_t; 0 on success.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta, int B, int H, int KV,
                                         int Sq, int Sk, int D, int causal, float scale,
                                         void* stream) {
  const float *qt = static_cast<const float*>(q), *kt = static_cast<const float*>(k),
              *vt = static_cast<const float*>(v), *ot = static_cast<const float*>(o),
              *dot = static_cast<const float*>(dout);
  float *dqt = static_cast<float*>(dq), *dkt = static_cast<float*>(dk),
        *dvt = static_cast<float*>(dv), *l = static_cast<float*>(lse),
        *dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(qt, kt, vt, ot, dot, dqt, dkt, dvt, l, dl, B, H, KV, Sq, Sk, causal,
                        scale, s);
    case 64:
      return launch<64>(qt, kt, vt, ot, dot, dqt, dkt, dvt, l, dl, B, H, KV, Sq, Sk, causal,
                        scale, s);
    case 128:
      return launch<128>(qt, kt, vt, ot, dot, dqt, dkt, dvt, l, dl, B, H, KV, Sq, Sk, causal,
                        scale, s);
    default: return cudaErrorInvalidValue;
  }
}
