// Flash attention backward in bfloat16 on Hopper's tensor cores (sm_90a).
//
// The gradient of the bfloat16 forward kernel in flash_attention_bf16.cu.
// It replaces no TPU kernel: the Pallas `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:36) has no backward, and the
// JAX package trains with its plain attention and takes the gradient by
// autodiff (src/repro/models/layers.py:136).  It exists so that a loss built
// through the forward kernel differentiates through a kernel too: every
// family's bfloat16 training on the card (qwen3-1.7b's 28 layers, whisper's
// encoder, decoder and cross-attention, zamba2's shared block) runs it once
// a layer.  The float32 gradient is flash_attention_bwd.cu's, on the same
// tensor cores as three TF32 wgmma products.
//
// Layout as the forward: q, o, dO, dq are [B, Sq, H, D], k, v, dk, dv are
// [B, Sk, KV, D], contiguous bfloat16, D in {32, 64, 128}; GQA without
// repeats (query head h reads kv head h / (H / KV)); causal masks key j >
// query i (Sq == Sk); keys past Sk and rows past Sq are loaded as zeros and
// masked, nothing is padded.  lse is the forward's float32 [B, H, Sq]
// log-sum-exp of the scaled, masked scores in natural-log units, as
// flash_attention_bf16.cu stores it; this kernel never recomputes it.
//
// With s = scale q.k, P = exp(s - lse) and delta_i = sum_d dO_id o_id:
//   dS = P (dO V^T - delta),  dq = scale dS K,  dk = scale dS^T Q,  dv = P^T dO,
// dk and dv of a kv head summed over its group of query heads.
//
// What bounds it on an H100: 10 Sq Sk D flops a head (half of it causal) on
// the bytes of q, k, v, o, dO, dq, dk, dv.  At the training shapes (qwen3's
// 256 tokens, zamba2's 512, whisper's 64 queries over 1500 frames) that is
// below the card's 295 flops a byte: bytes, a few microseconds.  At long S
// it is the bfloat16 tensor-core rate, 989 TFLOP/s, reached only through
// `wgmma`.  So the products run on `wgmma`, the log-sum-exp comes from the
// forward, delta is one pass over O and dO, and enough blocks are made to
// fill the card's 132 SMs.
//
// Design, a first redesign and not the last.  No atomics: two runs give
// equal bits.  Two launches (three where dq is split), the second behind the
// first as a programmatic dependent (PDL), so that its blocks start loading
// K, V, Q and dO while the first finishes:
//   1. flash_bwd_bf16_prep: per row, (lse log2 e, delta) into a float32
//      scratch, reading O and dO once (bytes-bound, D / 8 threads a row);
//   2. flash_bwd_bf16_main, one warpgroup (128 threads) a block, three kinds
//      of block side by side in one grid:
//      - dV and dK blocks, one each per (b, kv head, tile of 64 keys).  K
//        (and V) stay in shared memory; the block loops over the group's
//        query heads and their query tiles (causal: from the diagonal; the
//        longest blocks first), the Q and dO tiles and their rows' (lse,
//        delta) double-buffered by cp.async.  Per query tile:
//          S^T = K Q^T (and dP^T = V dO^T, one k-step at a time) as D/16
//          `wgmma.m64n64k16`, both operands K-major from shared memory;
//          P^T = exp2(S^T scale log2 e - lse log2 e) masked from the
//          accumulator's (row, column) map as the forward masks S; dS^T =
//          P^T (dP^T - delta); then dV += P^T dO or dK += dS^T Q, A from
//          registers (the accumulator's fragment of 16 queries is the next
//          `wgmma`'s A fragment, as in the forward) and dO or Q read
//          MN-major from their [query, d] tiles, as the forward reads V.
//        dV and dK in separate blocks keep a thread at one D / 2
//        accumulator (64 floats at D 128) beside S^T, dP^T, dS^T's three
//        terms and the tile's sum: at D 128 255 registers, 2 blocks an SM,
//        no spill (at D 64 207 registers, 2 blocks; at D 32 three).  It
//        costs S^T twice and doubles the blocks at the training shapes,
//        which is what they lack.
//      - dQ blocks, one per (b, h, query tile, split of the key range): S =
//        Q K^T and dP = dO V^T K-major, dQ += dS K with K read MN-major.
//        Where the (b, h, query tile) blocks alone would leave SMs idle
//        (whisper's cross-attention: 20 blocks), the wrapper splits each
//        key range (ops.dq_splits); each split writes float32 partials and
//   3. flash_bwd_bf16_combine sums them in split order, as flash-decode's
//      split and combine do.
//
// Numerics.  S and dP accumulate exact bfloat16 products in float32; P, dS
// and lse are float32; delta is summed in float64 and rounded to float32
// once.  A product whose A operand is P or dS rounded once to bfloat16
// moves a sum by up to 2^-9 of its terms, and dq and dk sum terms that
// cancel (each row of dS sums to 0), so dS is taken as hi + mid + lo, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): three bfloat16
// terms carry float32's 24 bits, three products accumulated in float32.
// Two terms (hi + lo) leave 2^-17 of each term, which a cancelling dq or dk
// keeps where |v| is large and dS with it (the init rule's weights give |v|
// ~ 150 on qwen3-1.7b's layer inputs): there they missed the one-step limit
// from the float64 gradient, though never at |v| ~ 1.  dv = P^T dO sums
// terms that do not cancel, so P stays at two terms (hi + lo).  A delta
// summed in float32 moves dS = P (dP - delta) by 2^-24 of sum |dO o| in
// every key of a row, which dq keeps whole where V is large.  The tensor
// core truncates what it adds into its accumulator, a bias toward zero that
// grows with the number of additions: summed over 128 query tiles (4096
// causal tokens) it left one element of dv 1.22 of the one-step limit.  So
// each tile's products go into a zeroed fragment, added to the running sum
// on the CUDA cores (round to nearest), which cut that bias about fourfold.
// dP meets the same bias inside one tile: D / 16 truncated additions into
// |dP| ~ |dO| |V| sqrt(D), against delta formed apart, leave each row of dS
// a sum that is no longer 0, and dq keeps it; so dP too is taken one k-step
// of 16 at a time, each into a zeroed fragment added on the CUDA cores.
// Each result rounds to bfloat16 once, at the store.
//
// Each tile's products wait for the previous step (no overlap of the
// elementwise work with the tensor cores, no TMA ring, no persistent grid):
// that is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

constexpr int BM = 64;     // rows of a tile, own (keys or queries) and other
constexpr int NT = WG;     // threads a block: one warpgroup
constexpr int PREP_NT = 256;
constexpr float LOG2E = 1.4426950408889634f;

enum Role { kDV = 0, kDK = 1, kDQ = 2 };

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float2* stats;  // [B, H, Sq]: (lse log2 e, delta)
  bf16 *dq, *dk, *dv;
  float* dq_part;       // [splits, B, Sq, H, D] when splits > 1
  size_t q_elems;       // B Sq H D
  int B, H, KV, Sq, Sk, causal, splits;
  float scale, scale_log2;
};

// Programmatic dependent launch: a kernel launched behind another with
// programmatic stream serialization may start once every block of the one
// before has called launch_dependents, and waits at griddep_wait until that
// one has finished and its writes are visible.  Without the attribute both
// do nothing.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// cp.async of 8 bytes; with ok false the destination is zero-filled.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

// Per row of q: (lse log2 e, delta = sum_d dO o), D / 8 threads a row, each
// reading 16 bytes of o and of dO; delta summed in float64.
template <int D>
__global__ void __launch_bounds__(PREP_NT)
flash_bwd_bf16_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float2* __restrict__ stats, int H, int Sq,
                    long rows) {
  constexpr int TPR = D / 8;
  griddep_launch_dependents();  // the main kernel's loads of K, V, Q, dO need nothing of this
  const long idx = (long)blockIdx.x * PREP_NT + threadIdx.x;
  const long r = idx / TPR;  // (b Sq + s) H + h
  const int u = idx % TPR;
  double acc = 0.0;  // exact: each product of two bfloat16 values fits a float64
  if (r < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + r * D + u * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + r * D + u * 8);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(pa[e]), fb = __bfloat1622float2(pb[e]);
      acc = fma((double)fa.x, (double)fb.x, acc);
      acc = fma((double)fa.y, (double)fb.y, acc);
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && u == 0) {
    const long bs = r / H;
    const size_t at = ((size_t)(bs / Sq) * H + r % H) * Sq + bs % Sq;
    stats[at] = make_float2(lse[at] * LOG2E, (float)acc);
  }
}

// One block's part of the gradient (see the note at the top).  "Own" is the
// block's 64 rows, kept in shared memory (K and V for kDV and kDK, Q and dO
// for kDQ); "other" the tiles it loops over (Q and dO, or K and V).  X is
// the operand of S (K or Q), Y the operand of dP (V or dO).  ``unit`` is
// b KV + kv head (kv side) or b H + h (q side), ``tile`` the own tile,
// ``split`` the part of the key range (q side).
template <int D, int ROLE>
__device__ __forceinline__ void backward_block(const Args a, uint8_t* smem, uint32_t smem_s,
                                               int unit, int tile, int split) {
  using T = Tile<D>;
  constexpr bool KV_SIDE = ROLE != kDQ;
  constexpr bool DP = ROLE != kDV;
  constexpr uint32_t TILE = BM * D * 2;
  const uint32_t x_s = smem_s, y_s = x_s + TILE;  // own X, own Y
  const uint32_t xo_s = y_s + TILE;               // other X, two stages
  const uint32_t yo_s = xo_s + 2 * TILE;          // other Y, two stages
  const uint32_t st_s = yo_s + 2 * TILE;          // other rows' stats, two stages
  const float2* st = reinterpret_cast<const float2*>(smem + 6 * TILE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);
  const int G = a.H / a.KV;
  const size_t q_row = (size_t)a.H * D, k_row = (size_t)a.KV * D;

  int b, h, kvh, own0, n;
  int qs = 0, per = 1, kb = 0;  // kv side: first query tile, tiles a head; q side: first key tile
  const bf16 *xg, *yg;
  if constexpr (KV_SIDE) {
    b = unit / a.KV;
    kvh = unit % a.KV;
    h = 0;
    own0 = tile * BM;
    const int nq = (a.Sq + BM - 1) / BM;
    qs = a.causal ? tile : 0;  // causal: Sq == Sk, so the diagonal tile
    per = nq - qs;
    n = G * per;
    xg = a.k + (size_t)b * a.Sk * k_row + (size_t)kvh * D;
    yg = a.v + (size_t)b * a.Sk * k_row + (size_t)kvh * D;
  } else {
    b = unit / a.H;
    h = unit % a.H;
    kvh = h / G;
    own0 = tile * BM;
    const int nk = (a.Sk + BM - 1) / BM;
    const int chunk = (nk + a.splits - 1) / a.splits;
    const int k_end = a.causal ? min(nk, tile + 1) : nk;
    kb = split * chunk;
    n = max(0, min(kb + chunk, k_end) - kb);
    xg = a.q + (size_t)b * a.Sq * q_row + (size_t)h * D;
    yg = a.dout + (size_t)b * a.Sq * q_row + (size_t)h * D;
  }
  const size_t own_stride = KV_SIDE ? k_row : q_row;
  const int own_rows = KV_SIDE ? a.Sk : a.Sq;
  // this thread's two own rows of the block's 64, and its columns
  const int row[2] = {own0 + warp * 16 + lane / 4, own0 + warp * 16 + lane / 4 + 8};

  // the other tile t: its first row, and its head (kv side)
  auto other_row0 = [&](int t) { return KV_SIDE ? (qs + t % per) * BM : (kb + t) * BM; };
  auto load_other = [&](int t) {
    const int s = t & 1, r0 = other_row0(t);
    if constexpr (KV_SIDE) {
      const int hh = kvh * G + t / per;
      const size_t base = (size_t)b * a.Sq * q_row + (size_t)hh * D;
      load_tile<D, BM>(xo_s + s * TILE, a.q + base, q_row, r0, a.Sq, tid);
      load_tile<D, BM>(yo_s + s * TILE, a.dout + base, q_row, r0, a.Sq, tid);
      if (tid < BM) {
        const bool ok = r0 + tid < a.Sq;
        cp_async8(st_s + (s * BM + tid) * 8,
                  a.stats + ((size_t)b * a.H + hh) * a.Sq + (ok ? r0 + tid : 0), ok);
      }
    } else {
      const size_t base = (size_t)b * a.Sk * k_row + (size_t)kvh * D;
      load_tile<D, BM>(xo_s + s * TILE, a.k + base, k_row, r0, a.Sk, tid);
      load_tile<D, BM>(yo_s + s * TILE, a.v + base, k_row, r0, a.Sk, tid);
    }
    cp_async_commit();
  };

  // dS (dK and dQ blocks) in three bfloat16 terms, P (dV blocks) in two
  constexpr int TERMS = DP ? 3 : 2;
  // tmp: step 4's zeroed fragment of the tile's sum, and in step 1 that of
  // one k-step of dP
  constexpr int TW = D / 2 > BM / 2 ? D / 2 : BM / 2;
  float acc[D / 2], tmp[TW], s[BM / 2], dp[BM / 2];
  float(&out_f)[D / 2] = *reinterpret_cast<float(*)[D / 2]>(&tmp[0]);
  float(&dp_f)[BM / 2] = *reinterpret_cast<float(*)[BM / 2]>(&tmp[0]);
  uint32_t frag[TERMS][BM / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TW; ++i) tmp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) s[i] = 0.f, dp[i] = 0.f;

  float2 own_st[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  if (n > 0) {
    load_tile<D, BM>(x_s, xg, own_stride, own0, own_rows, tid);
    if constexpr (DP) load_tile<D, BM>(y_s, yg, own_stride, own0, own_rows, tid);
    griddep_wait();  // the rows' stats come from the pre-pass
    load_other(0);   // one group with the own tiles
    if constexpr (!KV_SIDE) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (row[rr] < a.Sq) own_st[rr] = a.stats[((size_t)b * a.H + h) * a.Sq + row[rr]];
    }
  }
  for (int t = 0; t < n; ++t) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile t landed for every thread; every warp is done with t - 1
    if (t + 1 < n) load_other(t + 1);
    const int stage = t & 1, r0 = other_row0(t);
    const uint32_t xo = xo_s + stage * TILE, yo = yo_s + stage * TILE;

    // 1. S = X X_t^T (and dP = Y Y_t^T), both K-major in shared memory; dP
    //    one k-step at a time into a zeroed fragment, added on the CUDA
    //    cores
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t c = kk * 16 / T::CW, off = (kk * 16 % T::CW) * 2;
      wgmma_ss_n64(s, desc<D>(x_s + c * BM * T::RB + off, 16),
                   desc<D>(xo + c * BM * T::RB + off, 16), kk > 0);
    }
    wgmma_commit();
    if constexpr (DP) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t c = kk * 16 / T::CW, off = (kk * 16 % T::CW) * 2;
        pin(tmp);
        wgmma_fence();
        wgmma_ss_n64(dp_f, desc<D>(y_s + c * BM * T::RB + off, 16),
                     desc<D>(yo + c * BM * T::RB + off, 16), 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin(tmp);
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) dp[i] = kk > 0 ? dp[i] + dp_f[i] : dp_f[i];
      }
    }
    wgmma_wait<0>();
    pin(s);

    // 2. P = exp2(S scale log2 e - lse log2 e), masked; dS = P (dP - delta)
    const int key0 = KV_SIDE ? own0 : r0, query0 = KV_SIDE ? r0 : own0;
    const bool edge = key0 + BM > a.Sk || query0 + BM > a.Sq ||
                      (a.causal && key0 + BM - 1 > query0);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int rr = (i >> 1) & 1, c = 8 * (i / 4) + col + (i & 1);
      const float2 sv = KV_SIDE ? st[stage * BM + c] : own_st[rr];
      const int key = KV_SIDE ? row[rr] : r0 + c, query = KV_SIDE ? r0 + c : row[rr];
      const bool ok = !edge || (key < a.Sk && query < a.Sq && (!a.causal || key <= query));
      const float p = ok ? ex2(fmaf(s[i], a.scale_log2, -sv.x)) : 0.f;
      if constexpr (DP) s[i] = p * (dp[i] - sv.y);
      else s[i] = p;
    }
    // 3. x = hi (+ mid) + lo as A fragments: each term the bfloat16 rounding
    //    of what the ones before it leave (exact in float32)
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x0 = s[8 * kk + 2 * e], x1 = s[8 * kk + 2 * e + 1];
#pragma unroll
        for (int j = 0; j < TERMS; ++j) {
          const __nv_bfloat162 xh = __floats2bfloat162_rn(x0, x1);
          const float2 xf = __bfloat1622float2(xh);
          frag[j][kk][e] = bits(xh);
          x0 -= xf.x;
          x1 -= xf.y;
        }
      }

    // 4. out += sum of the terms' products with B, B MN-major from its [row,
    //    d] tile: dO for dV, Q for dK, K for dQ; the tile's sum in a zeroed
    //    fragment, added to the running sum on the CUDA cores
    const uint32_t bo = ROLE == kDV ? yo : xo;
    pin(tmp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const uint64_t db = desc<D>(bo + kk * 16 * T::RB, BM * T::RB);
#pragma unroll
      for (int j = 0; j < TERMS; ++j) wgmma_pv<D>(out_f, frag[j][kk], db, kk + j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(tmp);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += out_f[i];
  }

  // epilogue: the accumulator's rows are own rows, its columns d
  if constexpr (KV_SIDE) {
    const float f = ROLE == kDV ? 1.f : a.scale;
    bf16* out = (ROLE == kDV ? a.dv : a.dk) + (size_t)b * a.Sk * k_row + (size_t)kvh * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int rr = (i >> 1) & 1;
      if (row[rr] < a.Sk)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row[rr] * k_row + 8 * (i / 4) + col) =
            __floats2bfloat162_rn(acc[i] * f, acc[i + 1] * f);
    }
  } else if (a.splits == 1) {
    bf16* out = a.dq + (size_t)b * a.Sq * q_row + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int rr = (i >> 1) & 1;
      if (row[rr] < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row[rr] * q_row + 8 * (i / 4) + col) =
            __floats2bfloat162_rn(acc[i] * a.scale, acc[i + 1] * a.scale);
    }
  } else {  // this split's float32 partial, zeros where its key range is empty
    float* out = a.dq_part + split * a.q_elems + (size_t)b * a.Sq * q_row + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int rr = (i >> 1) & 1;
      if (row[rr] < a.Sq)
        *reinterpret_cast<float2*>(out + (size_t)row[rr] * q_row + 8 * (i / 4) + col) =
            make_float2(acc[i], acc[i + 1]);
    }
  }
}

// Shared memory: own X and Y, other X and Y in two stages, the other rows'
// stats in two stages, and room to align the tiles to 1024 bytes (the
// swizzle is a function of the address).
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)6 * BM * D * 2 + 2 * BM * sizeof(float2) + 1024;
}

#define ALIGNED_SMEM                                                          \
  extern __shared__ __align__(1024) uint8_t smem_raw[];                       \
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);        \
  const uint32_t pad = ((raw_s + 1023u) & ~1023u) - raw_s;

// One launch for all three roles: first the dV and dK blocks, key tile by
// key tile (causal: the longest first), then the dQ blocks, query tile by
// query tile (causal: the longest first); the two sides run side by side.
template <int D>
__global__ void __launch_bounds__(NT, D <= 32 ? 3 : 1) flash_bwd_bf16_main(const Args a) {
  ALIGNED_SMEM
  const int nq = (a.Sq + BM - 1) / BM;
  const int per_kt = a.B * a.KV * 2;
  const int n_kv = per_kt * ((a.Sk + BM - 1) / BM);
  int bid = blockIdx.x;
  if (bid < n_kv) {
    const int kt = bid / per_kt, r = bid % per_kt;
    if (r % 2 == 0)
      backward_block<D, kDV>(a, smem_raw + pad, raw_s + pad, r / 2, kt, 0);
    else
      backward_block<D, kDK>(a, smem_raw + pad, raw_s + pad, r / 2, kt, 0);
  } else {
    bid -= n_kv;
    const int per_qt = a.B * a.H * a.splits;
    const int qi = bid / per_qt, r = bid % per_qt;
    backward_block<D, kDQ>(a, smem_raw + pad, raw_s + pad, r / a.splits,
                           a.causal ? nq - 1 - qi : qi, r % a.splits);
  }
  griddep_launch_dependents();  // the combine reads the partials once this grid is done
}

// dq = scale * (sum of the splits' partials, in split order), 4 elements a
// thread.
__global__ void __launch_bounds__(PREP_NT)
flash_bwd_bf16_combine(const float4* __restrict__ part, bf16* __restrict__ dq, size_t n4,
                       int splits, float scale) {
  const size_t i = (size_t)blockIdx.x * PREP_NT + threadIdx.x;
  griddep_wait();  // every split's partial is written
  if (i >= n4) return;
  float4 s = part[i];
  for (int j = 1; j < splits; ++j) {
    const float4 x = part[j * n4 + i];
    s.x += x.x, s.y += x.y, s.z += x.z, s.w += x.w;
  }
  uint2 out;
  out.x = bits(__floats2bfloat162_rn(s.x * scale, s.y * scale));
  out.y = bits(__floats2bfloat162_rn(s.z * scale, s.w * scale));
  *reinterpret_cast<uint2*>(dq + 4 * i) = out;
}

// Launch `kernel` behind the stream's previous kernel as a programmatic
// dependent (see griddep_wait).
template <typename... P, typename... A>
cudaError_t launch_dependent(void (*kernel)(P...), unsigned blocks, int threads, size_t smem,
                             cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int D>
cudaError_t launch(Args a, const bf16* o, const float* lse, cudaStream_t stream) {
  const long nq = (a.Sq + BM - 1) / BM, nk = (a.Sk + BM - 1) / BM;
  const long blocks = 2L * a.B * a.KV * nk + (long)a.B * a.H * nq * a.splits;
  if (blocks >= (1L << 31) || a.H % a.KV || a.splits < 1 || a.splits > nk ||
      (a.causal && a.Sq != a.Sk))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_main<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long rows = (long)a.B * a.Sq * a.H;
  const long prep_threads = rows * (D / 8);
  flash_bwd_bf16_prep<D><<<(unsigned)((prep_threads + PREP_NT - 1) / PREP_NT), PREP_NT, 0,
                           stream>>>(o, a.dout, lse, const_cast<float2*>(a.stats), a.H, a.Sq,
                                     rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_dependent(flash_bwd_bf16_main<D>, (unsigned)blocks, NT, bytes, stream, a);
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t n4 = a.q_elems / 4;
  return launch_dependent(flash_bwd_bf16_combine, (unsigned)((n4 + PREP_NT - 1) / PREP_NT),
                          PREP_NT, 0, stream, reinterpret_cast<const float4*>(a.dq_part), a.dq,
                          n4, a.splits, a.scale);
}

}  // namespace

// C entry point, bound with ctypes: dq, dk, dv from q, k, v, the forward's
// output o, its gradient dout (all bfloat16) and its float32 log-sum-exp
// lse [B, H, Sq]; stats is float32 scratch of 2 B H Sq elements, dq_part of
// splits B Sq H D elements when splits > 1 (the key range of each query
// tile is cut in `splits` parts).  Returns a cudaError_t; 0 on success.
extern "C" int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const void* lse,
                                              void* dq, void* dk, void* dv, void* stats,
                                              void* dq_part, int B, int H, int KV, int Sq,
                                              int Sk, int D, int causal, int splits,
                                              float scale, void* stream) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.stats = static_cast<const float2*>(stats);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dq_part = static_cast<float*>(dq_part);
  a.q_elems = (size_t)B * Sq * H * D;
  a.B = B, a.H = H, a.KV = KV, a.Sq = Sq, a.Sk = Sk, a.causal = causal, a.splits = splits;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  const bf16* ot = static_cast<const bf16*>(o);
  const float* lt = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1 && dq_part == nullptr) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32>(a, ot, lt, s);
    case 64: return launch<64>(a, ot, lt, s);
    case 128: return launch<128>(a, ot, lt, s);
    default: return cudaErrorInvalidValue;
  }
}
