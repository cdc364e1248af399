// WKV6 recurrence (RWKV6 "Finch" time mixing) for Hopper (sm_90a), float32 or
// bfloat16 inputs, float32 arithmetic and state.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` behind `wkv6_bthk`
// (src/repro/kernels/rwkv6_wkv/kernel.py).  Per batch row b and head h, with
// r, k, v, w of shape [B,T,H,K], bonus u [H,K] and the state S [B,H,K,K]
// (row k, column v):
//
//     y_t[v] = sum_k r_t[k] S[k][v] + v_t[v] * sum_k u[k] k_t[k] r_t[k]
//     S[k][v] <- w_t[k] S[k][v] + k_t[k] v_t[v]
//
// y is written in the input type, the final state in float32.
//
// What bounds it on an H100: neither roofline.  About 5 K^2 float32 operations
// per (b, h, t) against 5 K values moved, so a long prompt sits near the
// float32 rate (67 TFLOP/s); but the T steps depend on each other, so a
// prompt of a few thousand tokens at batch 1 is bound by the latency of one
// step times T.
//
// Design (the shape of the public RWKV-LM CUDA kernel, with the state split
// across lanes): the Pallas kernel's sequential time axis becomes a loop
// inside the block.  Grid (B*H, VG): block (bh, g) owns the value columns
// [g*VPB, (g+1)*VPB) of S, VPB = K/VG; VG = 2 gives B*H*2 blocks, so a batch-1
// prefill of rwkv6-7b (64 heads) puts a block on almost every one of the 132
// SMs.  Each column is split over KS = 4 neighbouring lanes, each holding
// KP = K/4 rows of it in registers; y's sum over k ends in two xor shuffles.
// Time is walked in chunks of TC = 16 steps: the chunk's r, k, w rows and the
// block's v columns are brought into shared memory with cp.async one chunk
// ahead (two buffers), converted once to float32 (rows staggered by 4 floats
// per lane group, so the lanes' 16-byte reads hit distinct banks), and the
// bonus sum_k u k r of each step is computed once per chunk.  The chunk's y
// is staged in shared memory and written out in rows.  Any T >= 1: the last
// chunk is ragged.  The chunked, parallel-in-T form and tensor cores are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KS = 4;    // lanes per value column
constexpr int VG = 2;    // value-column groups (blocks) per (b, h)
constexpr int TC = 16;   // time steps per chunk

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 8 consecutive values from 16-byte aligned shared memory, as float32.
__device__ __forceinline__ void load8(const float* s, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* s, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}
// 4 consecutive values (8-byte aligned for bfloat16, 16 for float32).
__device__ __forceinline__ void load4(const float* s, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* s, float* out) {
  const uint2 a = *reinterpret_cast<const uint2*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  out[0] = f0.x; out[1] = f0.y; out[2] = f1.x; out[3] = f1.y;
}

template <typename T, int K>
__global__ void __launch_bounds__((K / VG) * KS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, const T* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int T_len, int H) {
  constexpr int VPB = K / VG;         // value columns of this block
  constexpr int KP = K / KS;          // state rows per lane
  constexpr int NT = VPB * KS;        // threads
  constexpr int G = NT / TC;          // lanes per time step in the conversion pass
  constexpr int E = K / G;            // r/k/w elements per lane in that pass
  constexpr int VE = VPB / G;         // v elements per lane in that pass
  constexpr int ROW = K + 4 * KS;     // staggered float32 row: lane group p at p*(KP+4)
  constexpr int EPC = 16 / sizeof(T); // elements per 16-byte copy
  static_assert(E == 8 && VE == 4, "conversion pass is written for 8 + 4 elements");
  static_assert(KP % 4 == 0 && (VPB * sizeof(T)) % 16 == 0, "16-byte rows");

  __shared__ __align__(16) T raw_r[2][TC][K];
  __shared__ __align__(16) T raw_k[2][TC][K];
  __shared__ __align__(16) T raw_w[2][TC][K];
  __shared__ __align__(16) T raw_v[2][TC][VPB];
  __shared__ __align__(16) float fr[TC][ROW];
  __shared__ __align__(16) float fk[TC][ROW];
  __shared__ __align__(16) float fw[TC][ROW];
  __shared__ __align__(16) float fv[TC][VPB];
  __shared__ float fbonus[TC];
  __shared__ float sy[TC][VPB];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int v0 = blockIdx.y * VPB;
  const int tid = threadIdx.x;
  const int p = tid % KS;             // this lane's rows: [p*KP, (p+1)*KP)
  const int c = tid / KS;             // this lane's column: v0 + c
  const int ct = tid / G;             // conversion pass: time step ...
  const int cp = tid % G;             // ... and part of the row

  const size_t step = (size_t)H * K;  // elements between time steps
  const size_t base = ((size_t)b * T_len * H + h) * K;
  const T *rb = r + base, *kb = k + base, *wb = w + base, *vb = v + base + v0;

  float S[KP];
  const float* s0p = s0 + (size_t)bh * K * K + v0 + c;
#pragma unroll
  for (int i = 0; i < KP; ++i) S[i] = s0p[(size_t)(p * KP + i) * K];
  float uu[E];
#pragma unroll
  for (int i = 0; i < E; ++i) uu[i] = to_f(u[(size_t)h * K + cp * E + i]);

  auto load_chunk = [&](int ch, int buf) {
    const int t0 = ch * TC;
    const int nt = min(TC, T_len - t0);
    constexpr int PR = K / EPC, PV = VPB / EPC;
    for (int i = tid; i < nt * PR; i += NT) {
      const int tt = i / PR, off = (i - tt * PR) * EPC;
      const size_t g = (size_t)(t0 + tt) * step + off;
      cp_async16(&raw_r[buf][tt][off], rb + g);
      cp_async16(&raw_k[buf][tt][off], kb + g);
      cp_async16(&raw_w[buf][tt][off], wb + g);
    }
    for (int i = tid; i < nt * PV; i += NT) {
      const int tt = i / PV, off = (i - tt * PV) * EPC;
      cp_async16(&raw_v[buf][tt][off], vb + (size_t)(t0 + tt) * step + off);
    }
    cp_async_commit();
  };

  const int nch = (T_len + TC - 1) / TC;
  load_chunk(0, 0);
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    const int t0 = ch * TC;
    const int nt = min(TC, T_len - t0);
    if (ch + 1 < nch) {
      load_chunk(ch + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Conversion pass: lane (ct, cp) converts elements [cp*E, cp*E+E) of
    // step ct's r, k, w and [cp*VE, cp*VE+VE) of its v, and sums its part of
    // the bonus; G neighbouring lanes finish the sum.  Steps past the end of
    // a ragged chunk convert stale data that no step reads.
    {
      float rr[E], kk[E], ww[E], vv[VE];
      load8(&raw_r[buf][ct][cp * E], rr);
      load8(&raw_k[buf][ct][cp * E], kk);
      load8(&raw_w[buf][ct][cp * E], ww);
      load4(&raw_v[buf][ct][cp * VE], vv);
      float bonus = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) bonus = fmaf(uu[i] * kk[i], rr[i], bonus);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) bonus += __shfl_xor_sync(FULL, bonus, off);
#pragma unroll
      for (int i = 0; i < E; i += 4) {
        const int kidx = cp * E + i;
        const int col = (kidx / KP) * (KP + 4) + kidx % KP;
        *reinterpret_cast<float4*>(&fr[ct][col]) = make_float4(rr[i], rr[i + 1], rr[i + 2], rr[i + 3]);
        *reinterpret_cast<float4*>(&fk[ct][col]) = make_float4(kk[i], kk[i + 1], kk[i + 2], kk[i + 3]);
        *reinterpret_cast<float4*>(&fw[ct][col]) = make_float4(ww[i], ww[i + 1], ww[i + 2], ww[i + 3]);
      }
      *reinterpret_cast<float4*>(&fv[ct][cp * VE]) = make_float4(vv[0], vv[1], vv[2], vv[3]);
      if (cp == 0) fbonus[ct] = bonus;
    }
    __syncthreads();

    const int rowoff = p * (KP + 4);
    for (int t = 0; t < nt; ++t) {
      const float vt = fv[t][c];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int i = 0; i < KP; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&fr[t][rowoff + i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&fk[t][rowoff + i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&fw[t][rowoff + i]);
        acc0 = fmaf(r4.x, S[i], acc0);
        acc1 = fmaf(r4.y, S[i + 1], acc1);
        acc0 = fmaf(r4.z, S[i + 2], acc0);
        acc1 = fmaf(r4.w, S[i + 3], acc1);
        S[i] = fmaf(w4.x, S[i], k4.x * vt);
        S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vt);
        S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vt);
        S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vt);
      }
      float part = acc0 + acc1;
#pragma unroll
      for (int off = KS / 2; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
      if (p == 0) sy[t][c] = fmaf(vt, fbonus[t], part);
    }
    __syncthreads();

    T* yb = y + base + (size_t)t0 * step + v0;
    for (int i = tid; i < nt * VPB; i += NT) {
      const int tt = i / VPB, cc = i - tt * VPB;
      store(yb + (size_t)tt * step + cc, sy[tt][cc]);
    }
  }

  float* sp = s_out + (size_t)bh * K * K + v0 + c;
#pragma unroll
  for (int i = 0; i < KP; ++i) sp[(size_t)(p * KP + i) * K] = S[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const float* s0, void* y, float* s_out, int B, int T_len, int H, int K,
           cudaStream_t stream) {
  const dim3 grid(B * H, VG);
  const T *rp = static_cast<const T*>(r), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *wp = static_cast<const T*>(w),
          *up = static_cast<const T*>(u);
  T* yp = static_cast<T*>(y);
  if (K == 64) {
    wkv6_kernel<T, 64><<<grid, (64 / VG) * KS, 0, stream>>>(rp, kp, vp, wp, up, s0, yp, s_out,
                                                            T_len, H);
  } else if (K == 32) {
    wkv6_kernel<T, 32><<<grid, (32 / VG) * KS, 0, stream>>>(rp, kp, vp, wp, up, s0, yp, s_out,
                                                            T_len, H);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  r, k, v, w: [B,T,H,K] contiguous, 16-byte
// aligned, float32 (dtype 0) or bfloat16 (dtype 1); u: [H,K] of the same type;
// s0, s_out: [B,H,K,K] float32; y: [B,T,H,K] of the input type.  K is 32 or
// 64, T >= 1.  Returns a cudaError_t; 0 on success.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const float* s0, void* y, float* s_out, int B,
                          int T_len, int H, int K, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, k, v, w, u, s0, y, s_out, B, T_len, H, K, st);
  if (dtype == 1) return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, T_len, H, K, st);
  return cudaErrorInvalidValue;
}
