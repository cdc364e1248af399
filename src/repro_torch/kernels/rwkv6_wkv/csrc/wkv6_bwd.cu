// Gradient of the WKV6 recurrence (RWKV6 "Finch" time mixing) for Hopper
// (sm_90a), float32 or bfloat16 inputs, float32 arithmetic and state.
//
// Replaces no TPU kernel: the JAX package trains rwkv6 through autodiff of
// its plain checkpointed scan (`wkv6_scan` in src/repro/models/rwkv6.py,
// whose Pallas kernel is forward-only), and this is that gradient on the
// card, so that a gradient never bypasses a kernel there.  Per batch row b
// and head h, with S_t the state after step t, dS_t its gradient (dS_{T-1}
// the final state's, zero when none is given), and vdy_t = v_t . dy_t:
//
//     dr_t = S_{t-1} dy_t + (u k_t) vdy_t
//     dk_t = dS_t v_t + (u r_t) vdy_t
//     dv_t = dS_t^T k_t + (sum_k u k_t r_t) dy_t
//     dw_t = sum_v dS_t . S_{t-1}
//     du  += sum_b (k_t r_t) vdy_t
//     dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
//
// and the initial state's gradient is dS_{-1}.  Gradients are written in the
// input type, dS_{-1} in float32 (ref.wkv6_bwd_ref is the same loop).
//
// Numerics.  S_{t-1} is never recovered from S_t by dividing by w_t: the
// model rounds exp(-exp(x)) to bfloat16, so w is exactly 0 (and 1) at times
// (wkv6.cu's header).  The kernel runs its own forward pass over T and keeps
// the state at the start of every chunk of C steps in a float32 workspace;
// walking the chunks back, it recomputes a chunk's C states from its stored
// start into shared memory and runs the reverse recurrence through them.
// Every sum is taken in float32 in a fixed order: no atomics, so two runs
// give the same bits.
//
// What bounds it on an H100: per (b, t, h) about 6 K V multiply-adds of
// essential work (the state recomputed, dr, the dS update, dk, dv, dw),
// against 5 K values read and 4 K written; at rwkv6-7b's heads (K 64) that
// is ~75 flops a byte in bfloat16, over the ~20 at which float32 work on the
// CUDA cores leaves memory behind, so the operations bound it.  This kernel
// does them on the CUDA cores, plus the forward pass that stores the chunk
// starts (2 K V flops a step again), and moves the workspaces besides.  The
// chunked matrix form on the tensor cores, as wkv6.cu takes it forward, is
// later work.
//
// Design.  The state's rows are independent in k and its columns in v; only
// the outputs couple them (dr, dk, dw sum over v, dv over k).  One block of
// 128 threads per (b, h, tile of KT = 16 rows of S): 4 B H blocks at K 64,
// 2 B H at K 32.  A block holds its rows whole, so dr, dk, dw and du are
// complete in it; dv sums over the K / KT row tiles, each tile writing its
// part to a float32 workspace that a second kernel sums in tile order (it
// also sums du's parts over the batch).  Thread (row, p), 8 a row, holds
// columns 32 g + 4 p .. + 3 of its row of S and dS in registers; its
// reductions over v are in-thread, then three shuffles across the row's 8
// lanes.  Per chunk:
//   1. the chunk's r, k, w (the block's rows), v and dy arrive in shared
//      memory as float32, with vdy_t and the tile's sum_k u k_t r_t;
//   2. each thread recomputes its elements of S_{t-1} for the chunk's steps
//      from the stored start, into shared memory (C KT V floats);
//   3. each thread walks the chunk back: dr, dk, dw for its row, dS_t k_t into
//      the slot of S_{t-1} once read, and dS <- diag(w_t) dS + r_t dy_t^T;
//   4. dr, dk, dw out; dv's part for the tile, summed over the tile's rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KT = 16;         // rows of S per block
constexpr int P = 8;           // threads per row
constexpr int NT = KT * P;     // threads per block
constexpr int C = 16;          // time steps per chunk
static_assert(C * P == NT, "one 8-lane group per step of a chunk for its sums");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x + __shfl_xor_sync(FULL, x, 4);
}

template <int K>
struct Layout {
  static constexpr int V = K;
  static constexpr int VE = V / P;   // columns per thread
  static constexpr int NG = VE / 4;  // float4 groups per thread: columns 32 g + 4 p ..
  static_assert(VE % 4 == 0 && K % KT == 0, "whole float4 groups, whole row tiles");
  // shared memory, in floats
  static constexpr int stash = 0;                    // [C][KT][V]: S_{t-1}, then dS_t k_t
  static constexpr int r = stash + C * KT * V;       // [C][KT]
  static constexpr int k = r + C * KT;
  static constexpr int w = k + C * KT;
  static constexpr int v = w + C * KT;               // [C][V]
  static constexpr int dy = v + C * V;
  static constexpr int u = dy + C * V;               // [KT]
  static constexpr int vdy = u + KT;                 // [C]
  static constexpr int ukr = vdy + C;                // [C]
  static constexpr int dr = ukr + C;                 // [C][KT]
  static constexpr int dk = dr + C * KT;
  static constexpr int dw = dk + C * KT;
  static constexpr size_t bytes = (size_t)(dw + C * KT) * 4;
};

template <typename T, int K>
__global__ void __launch_bounds__(NT)
wkv6_bwd_main(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ w, const T* __restrict__ u, const float* __restrict__ s0,
              const T* __restrict__ dy, const float* __restrict__ ds_out, T* __restrict__ dr,
              T* __restrict__ dk, T* __restrict__ dw, float* __restrict__ dv_part,
              float* __restrict__ du_part, float* __restrict__ dstate,
              float* __restrict__ ckpt, int T_len, int H) {
  using L = Layout<K>;
  constexpr int V = L::V, VE = L::VE, NG = L::NG, NKG = K / KT;
  extern __shared__ __align__(16) float sm[];
  float* stash = sm + L::stash;
  float *sr = sm + L::r, *sk = sm + L::k, *sw = sm + L::w;
  float *sv = sm + L::v, *sdy = sm + L::dy, *su = sm + L::u;
  float *svdy = sm + L::vdy, *sukr = sm + L::ukr;
  float *odr = sm + L::dr, *odk = sm + L::dk, *odw = sm + L::dw;

  const int tid = threadIdx.x;
  const int row = tid / P, p = tid % P;
  const int bh = blockIdx.x / NKG, kg = blockIdx.x % NKG;
  const int k0 = kg * KT;
  const int b = bh / H, h = bh - b * H;
  const size_t step = (size_t)H * K;                  // elements between time steps
  const size_t base = ((size_t)b * T_len * H + h) * K;
  const int nch = (T_len + C - 1) / C;
  int col[VE];
#pragma unroll
  for (int i = 0; i < VE; ++i) col[i] = 32 * (i / 4) + 4 * p + i % 4;
  // this thread's elements of a [K][K] state: row k0 + row, columns col[]
  const size_t srow = ((size_t)bh * K + k0 + row) * K;
  float* ck = ckpt + (size_t)bh * nch * K * K + (size_t)(k0 + row) * K;

  // the chunk's rows of r, k, w (r only for the backward), its v and dy
  auto load_chunk = [&](int t0, int nt, bool backward) {
    for (int i = tid; i < C * KT; i += NT) {
      const int tt = i / KT, rr = i % KT;
      const bool ok = tt < nt;
      const size_t g = base + (size_t)(t0 + tt) * step + k0 + rr;
      sk[i] = ok ? to_f(k[g]) : 0.f;
      sw[i] = ok ? to_f(w[g]) : 1.f;
      if (backward) sr[i] = ok ? to_f(r[g]) : 0.f;
    }
    for (int i = tid; i < C * V; i += NT) {
      const int tt = i / V, c = i % V;
      const bool ok = tt < nt;
      const size_t g = base + (size_t)(t0 + tt) * step + c;
      sv[i] = ok ? to_f(v[g]) : 0.f;
      if (backward) sdy[i] = ok ? to_f(dy[g]) : 0.f;
    }
  };
  auto load4 = [&](const float* src, float* x) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(src + 32 * g + 4 * p);
      x[4 * g] = a.x; x[4 * g + 1] = a.y; x[4 * g + 2] = a.z; x[4 * g + 3] = a.w;
    }
  };
  auto store4 = [&](float* dst, const float* x) {
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(dst + 32 * g + 4 * p) =
          make_float4(x[4 * g], x[4 * g + 1], x[4 * g + 2], x[4 * g + 3]);
  };
  // S <- diag(w_t) S + k_t v_t^T for the chunk's step tt, on this thread's elements
  auto advance = [&](float* S, int tt) {
    const float wt = sw[tt * KT + row], kt = sk[tt * KT + row];
    float vv[VE];
    load4(sv + tt * V, vv);
#pragma unroll
    for (int i = 0; i < VE; ++i) S[i] = fmaf(wt, S[i], kt * vv[i]);
  };

  // ---- the forward pass: the state at each chunk's start into the workspace
  float S[VE];
  load4(s0 + srow, S);
  for (int ch = 0; ch < nch; ++ch) {
    store4(ck + (size_t)ch * K * K, S);  // read back by this thread alone
    if (ch + 1 == nch) break;
    __syncthreads();
    load_chunk(ch * C, C, false);
    __syncthreads();
    for (int tt = 0; tt < C; ++tt) advance(S, tt);
  }

  // ---- the reverse pass
  float dS[VE];
  if (ds_out != nullptr) {
    load4(ds_out + srow, dS);
  } else {
#pragma unroll
    for (int i = 0; i < VE; ++i) dS[i] = 0.f;
  }
  if (tid < KT) su[tid] = to_f(u[(size_t)h * K + k0 + tid]);
  float du_acc = 0.f;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int t0 = ch * C, nt = min(C, T_len - t0);
    __syncthreads();  // the previous chunk's readers of shared memory are done
    load_chunk(t0, nt, true);
    __syncthreads();

    // 1. per step: vdy_t over all V, and sum_k u k_t r_t over the tile's rows
    {
      const int tt = tid / P;
      float vd = 0.f, ukr = 0.f;
#pragma unroll
      for (int i = 0; i < VE; ++i)
        vd = fmaf(sv[tt * V + col[i]], sdy[tt * V + col[i]], vd);
#pragma unroll
      for (int rr = p; rr < KT; rr += P)
        ukr = fmaf(su[rr] * sk[tt * KT + rr], sr[tt * KT + rr], ukr);
      vd = sum8(vd);
      ukr = sum8(ukr);
      if (p == 0) {
        svdy[tt] = vd;
        sukr[tt] = ukr;
      }
    }
    __syncthreads();

    // 2. S_{t-1} for each step of the chunk, from its stored start
    load4(ck + (size_t)ch * K * K, S);
    for (int tt = 0; tt < nt; ++tt) {
      store4(stash + (tt * KT + row) * V, S);
      advance(S, tt);
    }

    // 3. the chunk walked back
    const float ur = su[row];
    for (int tt = nt - 1; tt >= 0; --tt) {
      float* slot = stash + (tt * KT + row) * V;
      float sp[VE], dyv[VE], vv[VE];
      load4(slot, sp);
      load4(sdy + tt * V, dyv);
      load4(sv + tt * V, vv);
      const float kt = sk[tt * KT + row], rt = sr[tt * KT + row], wt = sw[tt * KT + row];
      float pr = 0.f, pk = 0.f, pw = 0.f, dvk[VE];
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        pr = fmaf(sp[i], dyv[i], pr);
        pk = fmaf(dS[i], vv[i], pk);
        pw = fmaf(dS[i], sp[i], pw);
        dvk[i] = dS[i] * kt;
        dS[i] = fmaf(wt, dS[i], rt * dyv[i]);
      }
      store4(slot, dvk);
      pr = sum8(pr);
      pk = sum8(pk);
      pw = sum8(pw);
      const float vd = svdy[tt];
      if (p == 0) {
        odr[tt * KT + row] = fmaf(ur * kt, vd, pr);
        du_acc = fmaf(kt * rt, vd, du_acc);
      } else if (p == 1) {
        odk[tt * KT + row] = fmaf(ur * rt, vd, pk);
      } else if (p == 2) {
        odw[tt * KT + row] = pw;
      }
    }
    __syncthreads();

    // 4. dr, dk, dw out; dv's part of this row tile
    for (int i = tid; i < nt * KT; i += NT) {
      const int tt = i / KT, rr = i % KT;
      const size_t g = base + (size_t)(t0 + tt) * step + k0 + rr;
      dr[g] = from_f<T>(odr[i]);
      dk[g] = from_f<T>(odk[i]);
      dw[g] = from_f<T>(odw[i]);
    }
    float* part = dv_part + (size_t)kg * (gridDim.x / NKG) * T_len * K;  // [B,T,H,K] each
    for (int i = tid; i < nt * V; i += NT) {
      const int tt = i / V, c = i % V;
      float acc = sukr[tt] * sdy[i];
#pragma unroll
      for (int rr = 0; rr < KT; ++rr) acc += stash[(tt * KT + rr) * V + c];
      part[base + (size_t)(t0 + tt) * step + c] = acc;
    }
  }
  store4(dstate + srow, dS);
  if (p == 0) du_part[(size_t)bh * K + k0 + row] = du_acc;
}

// dv = the sum of its NKG row tiles' parts, in tile order; du = the sum of
// its B parts, in batch order
template <typename T>
__global__ void wkv6_bwd_combine(const float* __restrict__ dv_part,
                                 const float* __restrict__ du_part, T* __restrict__ dv,
                                 T* __restrict__ du, size_t n, int nkg, int B, int HK) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n + HK; i += stride) {
    float acc = 0.f;
    if (i < n) {
      for (int g = 0; g < nkg; ++g) acc += dv_part[(size_t)g * n + i];
      dv[i] = from_f<T>(acc);
    } else {
      const size_t j = i - n;
      for (int bb = 0; bb < B; ++bb) acc += du_part[(size_t)bb * HK + j];
      du[j] = from_f<T>(acc);
    }
  }
}

template <typename T, int K>
int launch_k(const void* r, const void* k, const void* v, const void* w, const void* u,
             const float* s0, const void* dy, const float* ds_out, void* dr, void* dk,
             void* dv, void* dw, void* du, float* dstate, float* ckpt, float* dv_part,
             float* du_part, int B, int T_len, int H, cudaStream_t stream) {
  constexpr size_t bytes = Layout<K>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_main<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  wkv6_bwd_main<T, K><<<B * H * (K / KT), NT, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), s0, static_cast<const T*>(dy),
      ds_out, static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dw), dv_part,
      du_part, dstate, ckpt, T_len, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)B * T_len * H * K;
  const size_t total = n + (size_t)H * K;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  wkv6_bwd_combine<T><<<blocks, 256, 0, stream>>>(dv_part, du_part, static_cast<T*>(dv),
                                                  static_cast<T*>(du), n, K / KT, B, H * K);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const float* s0, const void* dy, const float* ds_out, void* dr, void* dk, void* dv,
           void* dw, void* du, float* dstate, float* ckpt, float* dv_part, float* du_part,
           int B, int T_len, int H, int K, cudaStream_t stream) {
  if (K == 64)
    return launch_k<T, 64>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du, dstate, ckpt,
                           dv_part, du_part, B, T_len, H, stream);
  if (K == 32)
    return launch_k<T, 32>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du, dstate, ckpt,
                           dv_part, du_part, B, T_len, H, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes.  r, k, v, w, dy: [B,T,H,K] contiguous,
// 16-byte aligned, float32 (dtype 0) or bfloat16 (dtype 1); u: [H,K] of the
// same type; s0: [B,H,K,K] float32; ds_out: the final state's gradient,
// [B,H,K,K] float32, or null for zero.  Out: dr, dk, dv, dw [B,T,H,K] and du
// [H,K] in the input type, dstate [B,H,K,K] float32.  Workspaces, float32:
// ckpt B H ceil(T / 16) K K, dv_part (K / 16) B T H K, du_part B H K.  K is
// 32 or 64, T >= 1.  Returns a cudaError_t; 0 on success.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const float* s0, const void* dy,
                              const float* ds_out, void* dr, void* dk, void* dv, void* dw,
                              void* du, float* dstate, float* ckpt, float* dv_part,
                              float* du_part, int B, int T_len, int H, int K, int dtype,
                              void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du, dstate, ckpt,
                         dv_part, du_part, B, T_len, H, K, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du, dstate,
                                 ckpt, dv_part, du_part, B, T_len, H, K, st);
  return cudaErrorInvalidValue;
}
