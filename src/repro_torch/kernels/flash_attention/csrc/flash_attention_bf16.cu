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
// p.  P V is taken as hi V + lo V with hi = bf16(p) and lo = bf16(p - hi),
// accumulated in float32, and the output is rounded to bfloat16 once, at the
// store.  Rounding p to bfloat16 once, as the TPU kernel does, moves an
// output by up to 2^-9 |v| where a few keys carry a row's weight (the early
// causal rows); that is many bfloat16 steps of a small output, and fails
// the port's one-step check against the exact softmax.  The split leaves an
// error of at most 2^-18 p, so the kernel agrees with the float32 plain
// version to one bfloat16 rounding, at the price of a third product (P V
// twice) beside the two of the TPU kernel.
//
// Design, simple first: one block of one warpgroup (128 threads) per (b*h,
// tile of 64 query rows), so that even at D = 128, about 230 registers a
// thread, two blocks fit on an SM; causal grids start with the longest
// tiles.  (Two warpgroups sharing each K/V tile were no faster on the card
// at qwen3's prefill lengths.)
// Q stays in shared memory; K and V tiles of 64 keys are double-buffered,
// brought in with cp.async, in the 128-byte swizzle (64-byte for D = 32)
// that `wgmma` reads: chunks of 64 columns in 8-row atoms, the 16-byte unit
// u of row r at u ^ (r % 8).  Per kv tile t:
//   1. S_t = Q K_t^T as D/16 `wgmma.m64n64k16`, Q and K both K-major from
//      shared memory;
//   2. masks S_t in registers from the accumulator's (row, column) map (row
//      16 warp + lane/4 (+8), column 8 j + 2 (lane % 4) (+1)) and takes the
//      online softmax, two xor shuffles per row;
//   3. packs p into hi and lo bfloat16 pairs: the S accumulator's fragment
//      of 16 keys is the A fragment of the next `wgmma`, so P never touches
//      shared memory;
//   4. O += hi V_t + lo V_t as 2 x 4 `wgmma.m64nDk16` with A from registers
//      and V read MN-major (transposed B) from its [key, d] tile.
// Step 4 of tile t - 1 is started together with step 1 of tile t, so the
// softmax of tile t runs while the tensor cores finish P_{t-1} V_{t-1}; the
// next tile's copies are started behind both.  No `wgmma` sits on a path
// that depends on the thread (ptxas serialises those).  TMA, a producer
// warp, a persistent grid and ping-pong between warpgroups are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // query rows per block: one warpgroup's wgmma M
constexpr int BK = 64;    // keys per kv tile
constexpr int NT = 128;   // threads per block: one warpgroup

// Shared-memory layout of a [rows, D] bfloat16 tile: D / CW chunks side by
// side, each [rows][CW] with rows of RB bytes in the swizzle `wgmma` reads.
template <int D>
struct Tile {
  static constexpr int CW = D < 64 ? D : 64;                 // columns per chunk
  static constexpr int RB = CW * 2;                          // 128 or 64 bytes
  static constexpr uint64_t MODE = RB == 128 ? 1 : 2;        // 128B / 64B swizzle
  // byte offset of 16-byte unit u of row r within a chunk
  __device__ static uint32_t at(int r, int u) {
    const int x = RB == 128 ? (r & 7) : ((r >> 1) & 3);
    return r * RB + ((u ^ x) << 4);
  }
};

// wgmma descriptor of a tile (smem_desc in wgmma.cuh): 8-row atoms of RB-byte
// rows in the tile's swizzle.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return smem_desc(addr, lbo, 8 * Tile<D>::RB, Tile<D>::MODE);
}

// Copy rows [row0, row0 + R) of a [*, D] matrix with row stride `stride`
// into the tile at `dst`; rows at or past `rows` are filled with zeros.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, size_t stride,
                                          int row0, int rows, int tid) {
  using T = Tile<D>;
  constexpr int UPR = D / 8, UPC = T::CW / 8;  // 16-byte units per row, per chunk row
  static_assert((R * UPR) % NT == 0, "tile does not split evenly over the threads");
#pragma unroll
  for (int i = 0; i < R * UPR / NT; ++i) {
    const int idx = tid + i * NT;
    const int r = idx / UPR, u = idx % UPR;
    const bool ok = row0 + r < rows;
    const bf16* g = src + (size_t)(ok ? row0 + r : 0) * stride + u * 8;
    const uint32_t s = dst + (u / UPC) * (R * T::RB) + T::at(r, u % UPC);
    cp_async16(s, g, ok);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// ---- wgmma: D[64 x N] (+)= A[64 x 16] B[16 x N], bfloat16 in, float32 out.
// _ss: A and B K-major in shared memory.  _rs: A from registers (the
// accumulator layout of 16 columns, packed in bfloat16 pairs), B MN-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, db, 1);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
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
  uint32_t hi[BK / 16][4], lo[BK / 16][4];  // P of the previous tile
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
  auto start_pv = [&](int t) {  // 4. O += hi V_t + lo V_t, P from registers, V MN-major
    const uint32_t v_t = v_s + (t & 1) * KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = desc<D>(v_t + kk * 16 * T::RB, BK * T::RB);
      wgmma_pv<D>(acc, hi[kk], dv);
      wgmma_pv<D>(acc, lo[kk], dv);
    }
    wgmma_commit();
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
  auto rescale_and_pack = [&]() {  // 3. O *= corr; p = hi + lo, as A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = s[8 * kk + 2 * e], x1 = s[8 * kk + 2 * e + 1];
        const __nv_bfloat162 ph = __floats2bfloat162_rn(x0, x1);
        const float2 pf = __bfloat1622float2(ph);
        hi[kk][e] = bits(ph);
        lo[kk][e] = bits(__floats2bfloat162_rn(x0 - pf.x, x1 - pf.y));
      }
  };

  load_tile<D, BQ>(q_s, qb, q_row, q0, Sq, tid);
  load_tile<D, BK>(k_s, kb, k_row, 0, Sk, tid);
  cp_async_commit();

  tiles_landed();  // Q, K_0
  pin(s);
  wgmma_fence();
  start_s(0);
  load_next(0);  // the copies start while the tensor cores work
  wgmma_wait<0>();
  pin(s);
  softmax(0);
  rescale_and_pack();
  // Step t runs S_t = Q K_t^T and O += P_{t-1} V_{t-1} on the tensor cores
  // together, and the softmax of S_t while P_{t-1} V_{t-1} runs.
  for (int t = 1; t < n_tiles; ++t) {
    tiles_landed();  // K_t, V_{t-1}
    pin(s);
    pin(acc);
    wgmma_fence();
    start_s(t);
    start_pv(t - 1);
    load_next(t);
    wgmma_wait<1>();  // S_t
    pin(s);
    softmax(t);
    wgmma_wait<0>();  // P_{t-1} V_{t-1}: O, hi and lo are free
    pin(acc);
    pin(s);
    rescale_and_pack();
  }
  tiles_landed();  // V_{n-1}
  pin(acc);
  wgmma_fence();
  start_pv(n_tiles - 1);
  wgmma_wait<0>();
  pin(acc);

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
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
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H,
                   int KV, int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = (size_t)(BQ + 4 * BK) * D * 2 + 1024;  // + alignment
  const unsigned tiles = (Sq + BQ - 1) / BQ;
  if (tiles > 65535u) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, tiles);
  flash_fwd_bf16<D><<<grid, NT, bytes, stream>>>(q, k, v, o, H, KV, Sq, Sk, causal,
                                                 scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  Returns a cudaError_t; 0 on success.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* o, int B, int H, int KV, int Sq, int Sk,
                                          int D, int causal, float scale, void* stream) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qt, kt, vt, ot, B, H, KV, Sq, Sk, causal, scale, s);
    case 64: return launch<64>(qt, kt, vt, ot, B, H, KV, Sq, Sk, causal, scale, s);
    case 128: return launch<128>(qt, kt, vt, ot, B, H, KV, Sq, Sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
