// Flash attention forward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// Replaces the bfloat16 route of the Pallas TPU kernel `_flash_kernel` behind
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/kernel.py:36):
// online-softmax attention with the running max m, the running sum l and the
// output accumulator in float32, native GQA (kv head = q head / group),
// causal masking when Sq == Sk, and masking of the ragged key tail.  The
// float32 route stays in flash_attention.cu.
//
// Layout: q and o are [B, Sq, H, D], k and v are [B, Sk, KV, D], contiguous
// bfloat16, D in {32, 64, 128}; the kernel reads that layout directly and the
// wrapper pads nothing.  Rows past Sq are loaded as zeros and never stored;
// keys past Sk are loaded as zeros and masked to -inf.
//
// What bounds it on an H100: operations.  A causal prefill of S tokens does
// 4 D flops for each of its S (S + 1) / 2 (query, key) pairs per head on 4 S D
// values per head; at S = 2500 that is far above the 295 flops a byte at
// which the card leaves memory behind, so the bound is the bfloat16
// tensor-core rate, 989 TFLOP/s, reached only through `wgmma`.
//
// Numerics.  S = Q K^T accumulates exact bfloat16 products in float32; m, l,
// the rescale factor and p = exp(s - m) are float32, and l sums the float32
// p.  P V is taken as hi V + mid V + lo V with hi = bf16(p), mid =
// bf16(p - hi) and lo = bf16(p - hi - mid): three bfloat16 terms carry p to
// float32's 24 bits, and V is exact in bfloat16.  Each tile's three products
// go into a zeroed fragment, added to O in float32 (round to nearest), and
// the output is rounded to bfloat16 once, at the store.  Rounding p to
// bfloat16 once, as the TPU kernel does, moves an output by up to 2^-9 |v|
// where a few keys carry a row's weight (the early causal rows); that is
// many bfloat16 steps of a small output.  Two terms (hi + lo) leave p's
// error at 2^-17 p, and an output that cancels keeps 2^-17 sum |p v| / l of
// it: where |v| is large (the init rule's weights give |v| ~ 150 on
// qwen3-1.7b's layer inputs, whose scores stay near 5, so the softmax is
// spread) that is several times the limit's absolute part, 1e-5, though
// never when |v| ~ 1.  The tensor core truncates what it adds into its
// accumulator; summed into O directly, twelve such additions a tile would
// bias a cancelling output by as much again, hence the zeroed fragment.
// On those layer inputs the kernel lies within one bfloat16 rounding of the
// float64 result, at the price of a fourth product (P V three times)
// beside the two of the TPU kernel.
//
// Design, simple first: one block of one warpgroup (128 threads) per (b*h,
// tile of 64 query rows), so that even at D = 128 (205 registers a thread)
// two blocks fit on an SM;
// causal grids start with the longest tiles.  (Two warpgroups sharing each
// K/V tile were no faster on the card at qwen3's prefill lengths.)
// Q stays in shared memory; K and V tiles of 64 keys are double-buffered,
// brought in with cp.async, in the 128-byte swizzle (64-byte for D = 32)
// that `wgmma` reads: chunks of 64 columns in 8-row atoms, the 16-byte unit
// u of row r at u ^ (r % 8).  Per kv tile t:
//   1. S_t = Q K_t^T as D/16 `wgmma.m64n64k16`, Q and K both K-major from
//      shared memory;
//   2. masks S_t in registers from the accumulator's (row, column) map (row
//      16 warp + lane/4 (+8), column 8 j + 2 (lane % 4) (+1)) and takes the
//      online softmax, two xor shuffles per row;
//   3. rescales O and packs p into hi, mid and lo bfloat16 pairs: the S
//      accumulator's fragment of 16 keys is the A fragment of the next
//      `wgmma`, so P never touches shared memory;
//   4. O += hi V_t + mid V_t + lo V_t, per chunk of 64 columns of V (one
//      for D <= 64, two for D = 128): 3 x 4 `wgmma.m64nNk16` (N = min(D,
//      64)) with A from registers and V read MN-major (transposed B) from
//      its [key, d] tile, into a zeroed fragment held in S's registers
//      (free once P is packed), added to O's columns of the chunk.
// Step 4 of tile t - 1 runs before step 1 of tile t, since both use S's
// registers (at D = 128 a fragment of its own would cost 64 registers a
// thread, and the block would no longer fit twice on an SM); the next
// tile's copies start behind step 1 and land during the softmax.  No
// `wgmma` sits on a path that depends on the thread (ptxas serialises
// those).  TMA, a producer warp, a persistent grid and ping-pong between
// warpgroups are later work.
//
// The log-sum-exp for the backward.  Where the caller passes a float32
// [B, H, Sq] buffer (training), the epilogue also stores each row's
// log-sum-exp of the scaled, masked scores in natural-log units,
// (m + log2 l) ln 2, with m the running max in the kernel's log2 units and
// l the row's sum: flash_attention_bwd_bf16.cu reads it instead of
// recomputing it.  With a null pointer (serving) the kernel does the same
// work and writes the same bits as without the option.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block: one warpgroup's wgmma M
constexpr int BK = 64;    // keys per kv tile
constexpr int NT = WG;    // threads per block: one warpgroup

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int H, int KV, int Sq, int Sk, int causal, float scale_log2) {
  using T = Tile<D>;
  constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle is a function of the address: align the tiles to 1024 bytes
  const uint32_t q_s = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + Q_BYTES;       // two stages
  const uint32_t v_s = k_s + 2 * KV_BYTES;  // two stages

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);  // native GQA: no repeated K/V
  // causal: the longest tiles (the last query rows) go first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;

  const size_t q_row = (size_t)H * D, k_row = (size_t)KV * D;
  const bf16* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const bf16* kb = k + (size_t)b * Sk * k_row + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * Sk * k_row + (size_t)kvh * D;
  bf16* ob = o + (size_t)b * Sq * q_row + (size_t)h * D;

  // causal: tiles past the block's last query row hold only masked keys
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  // this thread's two rows of the block's 64, and their columns
  const int row[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  const int col = 2 * (lane % 4);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[BK / 2], corr[2];
  uint32_t hi[BK / 16][4], mid[BK / 16][4], lo[BK / 16][4];  // P of the previous tile
  // step 4's fragment of PW columns of O: S's registers, free once P is packed
  constexpr int PW = D < 64 ? D : 64;
  float(&frag)[PW / 2] = *reinterpret_cast<float(*)[PW / 2]>(&s[0]);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  auto tiles_landed = [&]() {
    cp_async_wait<0>();
    fence_async_smem();
    // ... for every thread; and every warp is done with the stages the
    // next loads take (K_{t-1}, V_{t-2})
    __syncthreads();
  };
  auto load_next = [&](int t) {  // K_{t+1} and V_t, one group
    if (t + 1 < n_tiles)
      load_tile<D, BK>(k_s + ((t + 1) & 1) * KV_BYTES, kb, k_row, (t + 1) * BK, Sk, tid);
    load_tile<D, BK>(v_s + (t & 1) * KV_BYTES, vb, k_row, t * BK, Sk, tid);
    cp_async_commit();
  };
  auto start_s = [&](int t) {  // 1. S = Q K_t^T, Q and K K-major in shared memory
    const uint32_t k_t = k_s + (t & 1) * KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t c = kk * 16 / T::CW, off = (kk * 16 % T::CW) * 2;
      wgmma_ss_n64(s, desc<D>(q_s + c * BQ * T::RB + off, 16),
                   desc<D>(k_t + c * BK * T::RB + off, 16), kk > 0);
    }
    wgmma_commit();
  };
  auto pv = [&](int t) {  // 4. O += hi V_t + mid V_t + lo V_t, chunk by chunk of V
    const uint32_t v_t = v_s + (t & 1) * KV_BYTES;
#pragma unroll
    for (int c = 0; c < D / PW; ++c) {
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc<D>(v_t + c * BK * T::RB + kk * 16 * T::RB, BK * T::RB);
        wgmma_pv<PW>(frag, hi[kk], dv, kk > 0);
        wgmma_pv<PW>(frag, mid[kk], dv, 1);
        wgmma_pv<PW>(frag, lo[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
#pragma unroll
      for (int i = 0; i < PW / 2; ++i) acc[c * (PW / 2) + i] += frag[i];
    }
  };
  auto softmax = [&](int t) {  // 2. mask, scale to log2 units, online softmax
    const int k0 = t * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + col + (i & 1);
      s[i] *= scale_log2;
      if (edge && (key >= Sk || (causal && key > row[(i >> 1) & 1]))) s[i] = -INFINITY;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    }
    float base[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      const float mn = fmaxf(m[rr], mt[rr]);
      base[rr] = mn == -INFINITY ? 0.f : mn;  // a row with no key yet
      corr[rr] = ex2(m[rr] - base[rr]);
      m[rr] = mn;
      l[rr] *= corr[rr];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ex2(s[i] - base[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
  };
  auto rescale_and_pack = [&]() {  // 3. O *= corr; p = hi + mid + lo, as A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = s[8 * kk + 2 * e], x1 = s[8 * kk + 2 * e + 1];
        const __nv_bfloat162 ph = __floats2bfloat162_rn(x0, x1);
        const float2 pf = __bfloat1622float2(ph);
        const float r0 = x0 - pf.x, r1 = x1 - pf.y;  // exact in float32
        const __nv_bfloat162 pm = __floats2bfloat162_rn(r0, r1);
        const float2 mf = __bfloat1622float2(pm);
        hi[kk][e] = bits(ph);
        mid[kk][e] = bits(pm);
        lo[kk][e] = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
      }
  };

  load_tile<D, BQ>(q_s, qb, q_row, q0, Sq, tid);
  load_tile<D, BK>(k_s, kb, k_row, 0, Sk, tid);
  cp_async_commit();

  auto scores = [&](int t) {  // steps 1-3 of tile t
    pin(s);
    wgmma_fence();
    start_s(t);
    load_next(t);  // the copies start while the tensor cores work
    wgmma_wait<0>();
    pin(s);
    softmax(t);
    rescale_and_pack();
  };

  tiles_landed();  // Q, K_0
  scores(0);
  // Step t runs O += P_{t-1} V_{t-1}, then steps 1-3 of tile t, each behind
  // the one before.
  for (int t = 1; t < n_tiles; ++t) {
    tiles_landed();  // K_t, V_{t-1}
    pv(t - 1);
    scores(t);
  }
  tiles_landed();  // V_{n-1}
  pv(n_tiles - 1);

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    if (lse != nullptr && col == 0 && row[rr] < Sq)
      lse[(size_t)bh * Sq + row[rr]] = (m[rr] + log2f(l[rr])) * 0.6931471805599453f;
    l[rr] = 1.f / fmaxf(l[rr], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int rr = (i >> 1) & 1;
    if (row[rr] < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row[rr] * q_row + 8 * (i / 4) + col) =
          __floats2bfloat162_rn(acc[i] * l[rr], acc[i + 1] * l[rr]);
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B,
                   int H, int KV, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = (size_t)(BQ + 4 * BK) * D * 2 + 1024;  // + alignment
  const unsigned tiles = (Sq + BQ - 1) / BQ;
  if (tiles > 65535u) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, tiles);
  flash_fwd_bf16<D><<<grid, NT, bytes, stream>>>(q, k, v, o, lse, H, KV, Sq, Sk, causal,
                                                 scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes; lse is a float32 [B, H, Sq] buffer or
// null.  Returns a cudaError_t; 0 on success.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* o, void* lse, int B, int H, int KV, int Sq,
                                          int Sk, int D, int causal, float scale,
                                          void* stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(o);
  float* lt = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qt, kt, vt, ot, lt, B, H, KV, Sq, Sk, causal, scale, s);
    case 64: return launch<64>(qt, kt, vt, ot, lt, B, H, KV, Sq, Sk, causal, scale, s);
    case 128: return launch<128>(qt, kt, vt, ot, lt, B, H, KV, Sq, Sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
