// Flash attention backward in float32 on Hopper's tensor cores (sm_90a), as
// three TF32 products (3xTF32).
//
// The gradient of the float32 forward kernel in flash_attention.cu, which
// replaces the float32 route of the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:36).  The TPU kernel has no
// backward: the JAX package trains with its plain attention and takes the
// gradient by autodiff (src/repro/models/layers.py:136).  This kernel
// computes that same gradient, so that a loss built through the forward
// kernel differentiates through a kernel too: the launcher's float32
// presets and the Wan DiT's `diffusion_loss` run it once a layer.  It is a
// new kernel, not a port.  The bfloat16 gradient is its own kernel, in
// flash_attention_bwd_bf16.cu, whose structure this one follows.
//
// Layout as the forward: q, o, dO, dq are [B, Sq, H, D], k, v, dk, dv are
// [B, Sk, KV, D], contiguous float32, D in {32, 64, 128}; GQA without
// repeats (query head h reads kv head h / (H / KV)); causal masks key j >
// query i (Sq == Sk); keys past Sk and rows past Sq are loaded as zeros and
// masked, nothing is padded.  lse is the forward's float32 [B, H, Sq]
// log-sum-exp of the scaled, masked scores in natural-log units, as
// flash_attention.cu stores it; this kernel never recomputes it.
//
// With s = scale q.k, P = exp(s - lse) and delta_i = sum_d dO_id o_id:
//   dS = P (dO V^T - delta),  dq = scale dS K,  dk = scale dS^T Q,  dv = P^T dO,
// dk and dv of a kv head summed over its group of query heads.
//
// What bounds it on an H100: operations.  10 Sq Sk D flops a head (half of
// it causal) on the bytes of eight [S, D] tensors, far above the ~20 flops
// a byte at which float32 work leaves memory behind.  As three TF32 products
// on the tensor cores (495 TFLOP/s, 3 x the flops) a band of 2048 tokens of
// the Wan DiT ([1, 2048, 40, 128]) takes at least 1.30 ms, reached only
// through `wgmma`; on the CUDA cores (67 TFLOP/s) at least 3.2 ms.
//
// Numerics, as the forward's.  Each operand x is split into hi = x, of
// which the tensor core reads the top 10 mantissa bits (it drops the low
// 13), and lo = x - (x with its low 13 bits cleared), and every product is
// taken as lo hi' + hi lo' + hi hi': S = Q K^T and dP = dO V^T with their
// operands split in shared memory; dV = P^T dO, dK = dS^T Q and dQ = dS K
// with P and dS split in registers after they are formed in float32.  One
// TF32 product misses the float32 check (|a - b| <= 2e-5 + 2e-5 |b|).  The
// tensor core truncates each sum it adds into its accumulator, so dV, dK
// and dQ are not accumulated there: each tile's product goes into a zeroed
// accumulator (12 or 24 additions) and the running sum adds it on the CUDA
// cores, one rounded float32 add a tile (tests/test_torch_kernels.py
// emulates both, and one TF32 product).  P, dS, lse and delta are float32.
//
// Design, simple first.  No atomics: two runs give equal bits.  Two
// launches (three where dq is split), each behind the one before as a
// programmatic dependent (PDL), so that its blocks start loading while the
// one before finishes:
//   1. flash_bwd_f32_prep: per row, (lse log2 e, delta) into a float32
//      scratch, reading O and dO once (bytes-bound, D / 4 threads a row).
//      Nothing else needs zeroing: a dQ split with no keys writes zeros.
//   2. flash_bwd_f32_main, one warpgroup (128 threads) a block, three kinds
//      of block side by side in one grid, as the bfloat16 backward's:
//      - dV and dK blocks, one each per (b, kv head, tile of 64 keys): K
//        (and V) stay in shared memory, hi and lo; the block loops over the
//        group's query heads and their query tiles of BN rows (causal: from
//        the diagonal), S^T = K Q^T (and dP^T = V dO^T) from shared memory,
//        P^T = exp2(S^T scale log2 e - lse log2 e) masked, dS^T = P^T (dP^T
//        - delta), then dV += P^T dO or dK += dS^T Q, A from registers;
//      - dQ blocks, one per (b, h, tile of 64 queries, split of the key
//        range): S = Q K^T, dP = dO V^T, dQ += dS K.  Where the (b, h,
//        query tile) blocks alone would leave SMs idle, the wrapper splits
//        each key range (ops.dq_splits); each split writes float32 partials
//        and
//   3. flash_bwd_f32_combine sums them in split order.
//   dV and dK in separate blocks keep a thread at one D / 2 accumulator
//   beside S, dP, P or dS split, and a tile's product: at D 128 a block
//   takes that product in two halves of 64 columns, so that it stays under
//   255 registers (254 at D 128).  It costs S three times and dP twice
//   (eight products where five would do).
//
// Where the transposed copies are made.  TF32 `wgmma` reads both operands
// from shared memory K-major only: it has no transpose bit, as bfloat16 has.
// S and dP contract over D, which the tensors' [S, D] rows hold contiguous,
// but dV and dK contract over query rows and dQ over keys, so their B
// operand (dO, Q, K) must be stored transposed, [D, BN].  The block makes
// that copy itself, in shared memory, from the tile it has just loaded for
// S or dP (dV: from the dO tile): a thread pass that reads 16 bytes of a
// row and writes 4 floats down a column, hi and lo, with no bank conflict,
// while the tensor cores take S.  So each tile crosses from memory once, by
// 16-byte cp.async, and the pass needs no scratch in device memory and no
// wait on another kernel.  Each group of 8 rows goes to the columns 0 2 4 6
// 1 3 5 7: the accumulator holds columns 2t and 2t + 1 of a group where a
// TF32 A fragment takes t and t + 4, so P and dS go from the S accumulator
// to the A registers as they are (wgmma_tf32.cuh, a_frag).
//
// Shared memory.  Every tile is K-major, chunks of 32 floats with rows of
// 128 bytes in the 128-byte swizzle, hi and lo each: the block's own X and Y
// (K and V, or Q and dO) of 64 rows, the other side's X and Y of BN rows,
// their transposed copy T, and two stages of the other rows' (lse, delta).
// BN is 64, which keeps S's `wgmma` at N 64 (at N 32 its operands' bytes
// from shared memory outrun its arithmetic), save for the dK and dQ blocks
// at D 128: at 64 rows they would need 320 KB of a block's 227 KB, so they
// step by 32 rows (225.5 KB).  The dV block holds no own Y and no dO lo
// (its other Y is dO, read only as the source of T): 226 KB at D 128 with
// BN 64.  At D 64 a block takes 162 KB, at D 32 82 KB (two blocks an SM).
//
// Per other tile t, serial and single-buffered:
//   1. S (and dP) start on the tensor cores;
//   2. meanwhile the warpgroup writes T hi and lo;
//   3. once every warp is done, tile t + 1 is fetched into the free tiles
//      (past the last tile the copies fill zeros: one path for every step,
//      as the forward's note on ptxas 12.8 asks);
//   4. P and dS in registers, split; the tile's product into a zeroed
//      accumulator, then added to the running sum;
//   5. while the tensor cores take the product's last half, the warpgroup
//      writes the lo parts of tile t + 1.
// Only the copies and the lo parts overlap the tensor cores' work; a
// software pipeline, a TMA ring and warp specialisation are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int BM = 64;     // own rows of a block: one warpgroup's wgmma M
constexpr int NT = 128;    // threads a block: one warpgroup
constexpr int PREP_NT = 256;
constexpr float LOG2E = 1.4426950408889634f;

enum Role { kDV = 0, kDK = 1, kDQ = 2 };

// Rows of the other side a step: 64, but 32 for the dK and dQ blocks at D
// 128, whose tiles at 64 rows do not fit.
template <int D, int ROLE>
constexpr int OTHER_ROWS = D == 128 && ROLE != kDV ? 32 : 64;

struct Args {
  const float *q, *k, *v, *dout;
  const float2* stats;  // [B, H, Sq]: (lse log2 e, delta)
  float *dq, *dk, *dv;
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

// Per row of q: (lse log2 e, delta = sum_d dO o), D / 4 threads a row, each
// reading 16 bytes of o and of dO.
template <int D>
__global__ void __launch_bounds__(PREP_NT)
flash_bwd_f32_prep(const float* __restrict__ o, const float* __restrict__ dout,
                   const float* __restrict__ lse, float2* __restrict__ stats, int H, int Sq,
                   long rows) {
  constexpr int TPR = D / 4;
  griddep_launch_dependents();  // the main kernel's loads of K, V, Q, dO need nothing of this
  const long idx = (long)blockIdx.x * PREP_NT + threadIdx.x;
  const long r = idx / TPR;  // (b Sq + s) H + h
  const int u = idx % TPR;
  float acc = 0.f;
  if (r < rows) {
    const float4 a = *reinterpret_cast<const float4*>(o + r * D + u * 4);
    const float4 b = *reinterpret_cast<const float4*>(dout + r * D + u * 4);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && u == 0) {
    const long bs = r / H;
    const size_t at = ((size_t)(bs / Sq) * H + r % H) * Sq + bs % Sq;
    stats[at] = make_float2(lse[at] * LOG2E, acc);
  }
}

// Rows [row0, row0 + R) of a [*, D] matrix with row stride `stride` into a
// tile of R rows at `dst` by 16-byte cp.async; rows at or past `rows` are
// filled with zeros.
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src, size_t stride,
                                          int row0, int rows, int tid) {
  constexpr int UPR = D / 4;  // 16-byte units a row
  static_assert(R * UPR % NT == 0, "the tile does not split evenly over the threads");
#pragma unroll
  for (int j = 0; j < R * UPR / NT; ++j) {
    const int r = (tid + j * NT) / UPR, u = (tid + j * NT) % UPR;
    const bool ok = row0 + r < rows;
    cp_async16(dst + at<R>(r, u), src + (size_t)(ok ? row0 + r : 0) * stride + 4 * u, ok);
  }
}

// lo of a tile whose hi is at `hi`, 16 bytes a thread at a time: hi and lo
// share one layout.
__device__ __forceinline__ void split_tile(uint32_t hi, uint32_t lo, uint32_t bytes, int tid) {
#pragma unroll 4
  for (uint32_t off = tid * 16; off < bytes; off += NT * 16) sts4(lo + off, tf32_lo(lds4(hi + off)));
}

// T = the other tile at `src` ([BN, D]) transposed, hi at `th` and lo at
// `tl` ([D, BN]): row d, column p of T holds element d of row 8 (p / 8) + 2
// (p % 4) + (p / 4) % 2.  Lane l of a warp takes row 32 j + l and 16-byte
// unit u: a quarter warp reads 8 distinct bank groups, a warp writes 32
// distinct banks.
template <int D, int BN>
__device__ __forceinline__ void transpose(uint32_t src, uint32_t th, uint32_t tl, int warp,
                                          int lane) {
  constexpr int RB = BN / 32, WARPS = NT / 32;
  static_assert(RB * (D / 4) % WARPS == 0, "the tile does not split evenly over the warps");
#pragma unroll 2
  for (int i = 0; i < RB * (D / 4) / WARPS; ++i) {
    const int j = warp + i * WARPS, r = 32 * (j % RB) + lane, u = j / RB;
    const float4 x = lds4(src + at<BN>(r, u));
    const int p = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t off = at<D>(4 * u + c, p >> 2) + 4 * (p & 3);
      sts1(th + off, e[c]);
      sts1(tl + off, tf32_lo(e[c]));
    }
  }
}

// One block's part of the gradient (see the note at the top).  "Own" is the
// block's 64 rows (K and V for kDV and kDK, Q and dO for kDQ); "other" the
// tiles it loops over (Q and dO, or K and V).  X is the operand of S (K or
// Q), Y the operand of dP (V or dO).  ``unit`` is b KV + kv head (kv side)
// or b H + h (q side), ``tile`` the own tile, ``split`` the part of the key
// range (q side).
template <int D, int ROLE>
__device__ __forceinline__ void backward_block(const Args a, uint8_t* smem, uint32_t smem_s,
                                               int unit, int tile, int split) {
  constexpr int BN = OTHER_ROWS<D, ROLE>;
  constexpr bool KV_SIDE = ROLE != kDQ;
  constexpr bool DP = ROLE != kDV;
  constexpr int NH = D == 128 ? 2 : 1, NW = D / NH;  // the product's halves, their columns
  constexpr uint32_t OWN = BM * D * 4, OTHER = BN * D * 4;
  // (the dV block holds no own Y and no other Y lo)
  const uint32_t xh = smem_s, xl = xh + OWN, yh = xl + OWN, yl = yh + OWN;  // own X, Y
  const uint32_t oxh = DP ? yl + OWN : xl + OWN, oxl = oxh + OTHER;          // other X
  const uint32_t oyh = oxl + OTHER, oyl = oyh + OTHER;                       // other Y
  const uint32_t th = DP ? oyl + OTHER : oyh + OTHER, tl = th + OTHER;      // T
  const uint32_t st_s = tl + OTHER;  // the other rows' stats, two stages
  const float2* st = reinterpret_cast<const float2*>(smem + (st_s - smem_s));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);
  const int G = a.H / a.KV;
  const size_t q_row = (size_t)a.H * D, k_row = (size_t)a.KV * D;
  const int own0 = tile * BM;

  int b, h = 0, kvh, n;
  int qs = 0, per = 1, kb = 0;  // kv side: first query tile, tiles a head; q side: first key tile
  const float *xg, *yg;
  if constexpr (KV_SIDE) {
    b = unit / a.KV;
    kvh = unit % a.KV;
    qs = a.causal ? own0 / BN : 0;  // causal: Sq == Sk, so the diagonal tile
    per = (a.Sq + BN - 1) / BN - qs;
    n = G * per;
    xg = a.k + (size_t)b * a.Sk * k_row + (size_t)kvh * D;
    yg = a.v + (size_t)b * a.Sk * k_row + (size_t)kvh * D;
  } else {
    b = unit / a.H;
    h = unit % a.H;
    kvh = h / G;
    const int nk = (a.Sk + BN - 1) / BN;
    const int chunk = (nk + a.splits - 1) / a.splits;
    const int k_end = a.causal ? min(nk, (own0 + BM) / BN) : nk;
    kb = split * chunk;
    n = max(0, min(kb + chunk, k_end) - kb);
    xg = a.q + (size_t)b * a.Sq * q_row + (size_t)h * D;
    yg = a.dout + (size_t)b * a.Sq * q_row + (size_t)h * D;
  }
  const size_t own_stride = KV_SIDE ? k_row : q_row;
  const int own_rows = KV_SIDE ? a.Sk : a.Sq;
  // this thread's two own rows of the block's 64
  const int row[2] = {own0 + warp * 16 + lane / 4, own0 + warp * 16 + lane / 4 + 8};

  // The other tile t: its first row.  Past the last tile (t == n) every row
  // is loaded as zeros from row 0 of a valid head.
  auto other_row0 = [&](int t) { return KV_SIDE ? (qs + t % per) * BN : (kb + t) * BN; };
  auto load_other = [&](int t) {
    const bool live = t < n;
    const int tt = live ? t : 0, s = t & 1, r0 = other_row0(tt);
    if constexpr (KV_SIDE) {
      const int hh = kvh * G + tt / per, lim = live ? a.Sq : 0;
      const size_t base = (size_t)b * a.Sq * q_row + (size_t)hh * D;
      load_rows<D, BN>(oxh, a.q + base, q_row, r0, lim, tid);
      load_rows<D, BN>(oyh, a.dout + base, q_row, r0, lim, tid);
      if (tid < BN) {
        const bool ok = r0 + tid < lim;
        cp_async8(st_s + (s * BN + tid) * 8,
                  a.stats + ((size_t)b * a.H + hh) * a.Sq + (ok ? r0 + tid : 0), ok);
      }
    } else {
      const int lim = live ? a.Sk : 0;
      const size_t base = (size_t)b * a.Sk * k_row + (size_t)kvh * D;
      load_rows<D, BN>(oxh, a.k + base, k_row, r0, lim, tid);
      load_rows<D, BN>(oyh, a.v + base, k_row, r0, lim, tid);
    }
    cp_async_commit();
  };

  float acc[D / 2], tmp[NW / 2], s[BN / 2], dp[BN / 2], xlo[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) tmp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f, dp[i] = 0.f;

  float2 own_st[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  if (n > 0) {
    load_rows<D, BM>(xh, xg, own_stride, own0, own_rows, tid);
    if constexpr (DP) load_rows<D, BM>(yh, yg, own_stride, own0, own_rows, tid);
    griddep_wait();  // the rows' stats come from the pre-pass
    load_other(0);   // one group with the own tiles
    if constexpr (!KV_SIDE) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (row[rr] < a.Sq) own_st[rr] = a.stats[((size_t)b * a.H + h) * a.Sq + row[rr]];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the own tiles and tile 0 landed for every thread
  auto split_other = [&]() {
    split_tile(oxh, oxl, OTHER, tid);
    if constexpr (DP) split_tile(oyh, oyl, OTHER, tid);
  };
  split_tile(xh, xl, OWN, tid);
  if constexpr (DP) split_tile(yh, yl, OWN, tid);
  split_other();

  for (int t = 0; t < n; ++t) {
    const int stage = t & 1, r0 = other_row0(t);
    // 1. S = X X_t^T (and dP = Y Y_t^T) as (lo hi' + hi lo') + hi hi' over
    //    D / 8 steps, both from shared memory
    fence_async_smem();
    __syncthreads();  // tile t's lo parts written; every warp is done with T
    pin(s);
    if constexpr (DP) pin(dp);
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < 3; ++pr)
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t ao = (kk / 4) * (BM * 128) + (kk % 4) * 32;
        const uint32_t bo = (kk / 4) * (BN * 128) + (kk % 4) * 32;
        wgmma_ss<BN>(s, desc((pr == 0 ? xl : xh) + ao), desc((pr == 1 ? oxl : oxh) + bo),
                     pr > 0 || kk > 0);
        if constexpr (DP)
          wgmma_ss<BN>(dp, desc((pr == 0 ? yl : yh) + ao), desc((pr == 1 ? oyl : oyh) + bo),
                       pr > 0 || kk > 0);
      }
    wgmma_commit();
    // 2. T = the other tile transposed, hi and lo, while the tensor cores
    //    take S: dO for dV, Q for dK, K for dQ
    transpose<D, BN>(ROLE == kDV ? oyh : oxh, th, tl, warp, lane);
    fence_async_smem();
    wgmma_wait<0>();
    pin(s);
    if constexpr (DP) pin(dp);
    __syncthreads();  // T from every thread; every warp's S is done: the other tiles are free
    // 3. tile t + 1 (zeros past the last)
    load_other(t + 1);

    // 4. P = exp2(S scale log2 e - lse log2 e), masked; dS = P (dP - delta);
    //    x = hi + lo, hi being x as the tensor core reads it
    const int key0 = KV_SIDE ? own0 : r0, query0 = KV_SIDE ? r0 : own0;
    const int keys = KV_SIDE ? BM : BN, queries = KV_SIDE ? BN : BM;
    const bool edge = key0 + keys > a.Sk || query0 + queries > a.Sq ||
                      (a.causal && key0 + keys - 1 > query0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int rr = (i >> 1) & 1, c = 8 * (i / 4) + col + (i & 1);
      const float2 sv = KV_SIDE ? st[stage * BN + c] : own_st[rr];
      const int key = KV_SIDE ? row[rr] : r0 + c, query = KV_SIDE ? r0 + c : row[rr];
      const bool ok = !edge || (key < a.Sk && query < a.Sq && (!a.causal || key <= query));
      const float p = ok ? ex2(fmaf(s[i], a.scale_log2, -sv.x)) : 0.f;
      if constexpr (DP) s[i] = p * (dp[i] - sv.y);
      else s[i] = p;
      xlo[i] = tf32_lo(s[i]);
    }
    //    out += (lo T_hi + hi T_lo) + hi T_hi over BN / 8 steps, A from
    //    registers, in NH halves of NW columns; each half's sum in a zeroed
    //    accumulator, added to the running sum on the CUDA cores
    auto add_half = [&](int hh) {
      wgmma_wait<0>();
      pin(tmp);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[hh * (NW / 2) + i] += tmp[i];
    };
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      pin(tmp);
      wgmma_fence();
#pragma unroll
      for (int pr = 0; pr < 3; ++pr)
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          uint32_t af[4];
          if (pr == 0) a_frag(xlo, kk, af);
          else a_frag(s, kk, af);
          wgmma_rs<NW>(tmp, af,
                       desc((pr == 1 ? tl : th) + hh * NW * 128 + (kk / 4) * (D * 128) +
                            (kk % 4) * 32),
                       pr > 0 || kk > 0);
        }
      wgmma_commit();
      if (hh + 1 < NH) add_half(hh);
    }
    // 5. the lo parts of tile t + 1 while the tensor cores take the last half
    cp_async_wait<0>();
    __syncthreads();  // tile t + 1 landed for every thread
    split_other();
    add_half(NH - 1);
  }

  // epilogue: the accumulator's rows are own rows, its columns d
  if constexpr (KV_SIDE) {
    const float f = ROLE == kDV ? 1.f : a.scale;
    float* out = (ROLE == kDV ? a.dv : a.dk) + (size_t)b * a.Sk * k_row + (size_t)kvh * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int rr = (i >> 1) & 1;
      if (row[rr] < a.Sk)
        *reinterpret_cast<float2*>(out + (size_t)row[rr] * k_row + 8 * (i / 4) + col) =
            make_float2(acc[i] * f, acc[i + 1] * f);
    }
  } else {  // dq, or this split's float32 partial (zeros where its key range is empty)
    const bool whole = a.splits == 1;
    const float f = whole ? a.scale : 1.f;
    float* out = (whole ? a.dq : a.dq_part + split * a.q_elems) + (size_t)b * a.Sq * q_row +
                 (size_t)h * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int rr = (i >> 1) & 1;
      if (row[rr] < a.Sq)
        *reinterpret_cast<float2*>(out + (size_t)row[rr] * q_row + 8 * (i / 4) + col) =
            make_float2(acc[i] * f, acc[i + 1] * f);
    }
  }
}

// Shared memory of a role: own X and Y, other X and Y, and T, each hi and
// lo (the dV block without own Y and other Y lo); the other rows' stats in
// two stages.
template <int D, int ROLE>
constexpr size_t role_bytes() {
  constexpr int BN = OTHER_ROWS<D, ROLE>;
  return (size_t)(ROLE == kDV ? 2 * BM + 5 * BN : 4 * BM + 6 * BN) * D * 4 +
         2 * BN * sizeof(float2);
}
// A block's: the larger role's, and room to align the tiles to 1024 bytes
// (the swizzle is a function of the address).
template <int D>
constexpr size_t smem_bytes() {
  return (role_bytes<D, kDV>() > role_bytes<D, kDK>() ? role_bytes<D, kDV>()
                                                      : role_bytes<D, kDK>()) + 1024;
}
static_assert(smem_bytes<128>() <= 232448, "more shared memory than a block may have");

// One launch for all three roles: first the dV and dK blocks, key tile by
// key tile (causal: the longest first), then the dQ blocks, query tile by
// query tile (causal: the longest first); the two sides run side by side.
template <int D>
__global__ void __launch_bounds__(NT, D == 32 ? 2 : 1) flash_bwd_f32_main(const Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t pad = ((raw_s + 1023u) & ~1023u) - raw_s;
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
flash_bwd_f32_combine(const float4* __restrict__ part, float4* __restrict__ dq, size_t n4,
                      int splits, float scale) {
  const size_t i = (size_t)blockIdx.x * PREP_NT + threadIdx.x;
  griddep_wait();  // every split's partial is written
  if (i >= n4) return;
  float4 s = part[i];
  for (int j = 1; j < splits; ++j) {
    const float4 x = part[j * n4 + i];
    s.x += x.x, s.y += x.y, s.z += x.z, s.w += x.w;
  }
  dq[i] = make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale);
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
cudaError_t launch(Args a, const float* o, const float* lse, cudaStream_t stream) {
  const long nq = (a.Sq + BM - 1) / BM, nk = (a.Sk + BM - 1) / BM;
  const long blocks = 2L * a.B * a.KV * nk + (long)a.B * a.H * nq * a.splits;
  if (blocks >= (1L << 31) || a.H % a.KV || a.splits < 1 ||
      a.splits > (a.Sk + OTHER_ROWS<D, kDQ> - 1) / OTHER_ROWS<D, kDQ> ||
      (a.causal && a.Sq != a.Sk))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_main<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long rows = (long)a.B * a.Sq * a.H;
  const long prep_threads = rows * (D / 4);
  flash_bwd_f32_prep<D><<<(unsigned)((prep_threads + PREP_NT - 1) / PREP_NT), PREP_NT, 0,
                          stream>>>(o, a.dout, lse, const_cast<float2*>(a.stats), a.H, a.Sq,
                                    rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_dependent(flash_bwd_f32_main<D>, (unsigned)blocks, NT, bytes, stream, a);
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t n4 = a.q_elems / 4;
  return launch_dependent(flash_bwd_f32_combine, (unsigned)((n4 + PREP_NT - 1) / PREP_NT),
                          PREP_NT, 0, stream, reinterpret_cast<const float4*>(a.dq_part),
                          reinterpret_cast<float4*>(a.dq), n4, a.splits, a.scale);
}

}  // namespace

// C entry point, bound with ctypes: dq, dk, dv from q, k, v, the forward's
// output o, its gradient dout (all float32) and its float32 log-sum-exp lse
// [B, H, Sq]; stats is float32 scratch of 2 B H Sq elements, dq_part of
// splits B Sq H D elements when splits > 1 (the key range of each query
// tile is cut in `splits` parts).  Returns a cudaError_t; 0 on success.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv, void* stats,
                                         void* dq_part, int B, int H, int KV, int Sq, int Sk,
                                         int D, int causal, int splits, float scale,
                                         void* stream) {
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.stats = static_cast<const float2*>(stats);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dq_part = static_cast<float*>(dq_part);
  a.q_elems = (size_t)B * Sq * H * D;
  a.B = B, a.H = H, a.KV = KV, a.Sq = Sq, a.Sk = Sk, a.causal = causal, a.splits = splits;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  const float* ot = static_cast<const float*>(o);
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
