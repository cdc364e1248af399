// Flash attention forward in float32 on Hopper's tensor cores (sm_90a), as
// three TF32 products (3xTF32).  The bfloat16 route is its own kernel, in
// flash_attention_bf16.cu.
//
// Replaces the float32 route of the Pallas TPU kernel `_flash_kernel` behind
// `flash_attention_bhsd` (src/repro/kernels/flash_attention/kernel.py:36):
// online-softmax attention with the running max m, the running sum l and the
// output accumulator in float32, native GQA (kv head = q head / group),
// causal masking when Sq == Sk, and masking of the ragged key tail.
//
// Layout: q and o are [B, Sq, H, D], k and v are [B, Sk, KV, D], contiguous
// float32, D in {32, 64, 128}; the kernel reads that layout directly and the
// wrapper pads nothing.  Rows past Sq are loaded as zeros and never stored;
// keys past Sk are loaded as zeros and masked to -inf.  Given a float32
// [B, H, Sq] lse buffer (training), the kernel also stores each row's
// log-sum-exp of the scaled, masked scores in natural-log units, (m log2 e +
// log2 l) ln 2, which flash_attention_bwd.cu reads instead of recomputing
// it; with a null pointer (serving) it does the same work and writes the same
// bits of o.
//
// What bounds it on an H100: operations.  Attention does 4 D flops for each
// (query, key) pair of a head on 4 D values per row, far above the ~20 flops
// a byte at which float32 work leaves memory behind.  Outside the tensor
// cores (67 TFLOP/s) the DiT's self-attention, [1, 18900, 40, 128], takes at
// least 109 ms; as three TF32 products on the tensor cores (495 TFLOP/s, so
// 3 x the flops) at least 44 ms, reached only through `wgmma`.
//
// Numerics.  TF32 keeps 10 of float32's 23 mantissa bits, and one TF32
// product misses the port's float32 check (|a - b| <= 2e-5 + 2e-5 |b|) many
// times over.  So each operand x is split in two: hi is x itself, of which
// the tensor core reads the sign, the exponent and the top 10 mantissa bits
// (it drops the low 13), and lo = x - (x with its low 13 bits cleared),
// exact in float32 and truncated by the tensor core in its turn.  Both
// products are taken as lo hi' + hi lo' + hi hi' in the float32 accumulator:
// S = (scale Q) K^T, and P V with P split after the exponent.  hi and lo must
// come from the same rounding: a lo taken against a round-to-nearest hi while
// the tensor core truncates hi misses the check too (tests/test_torch_kernels.py
// emulates each choice; tests/test_torch_cuda.py holds the kernel on inputs
// whose low 13 bits are all set).  The tensor core also truncates each sum it
// adds into its accumulator, so O is not accumulated there: each tile's P V
// goes into a zeroed accumulator (24 additions) and O = corr O + P V is one
// rounded float32 FMA a tile.  Added into one accumulator, the 7,000 sums of
// the DiT's 18,900 keys drift towards zero by up to most of the limit.  m,
// l, the rescale factor and p are float32; l sums the float32 p.
//
// Design, simple first: one block of one warpgroup (128 threads) per (tile
// of 64 query rows, b*h), the query tiles fastest, so the blocks on the card
// at one time share a head's K and V in L2; causal grids start with the
// longest tiles.  Shared memory holds six float32 tiles of 64 x D (192 KB at
// D = 128, one block an SM): Q hi and lo for the whole kv loop, and one
// 64-key tile each of K hi, K lo, V^T hi and V^T lo.  Every tile is K-major,
// in chunks of 32 floats with rows of 128 bytes in the 128-byte swizzle
// (16-byte unit u of row r at u ^ (r % 8)): TF32 `wgmma` reads both operands
// from shared memory K-major only, so V is stored transposed.  K arrives by
// 16-byte cp.async straight into its hi tile; V by 4-byte cp.async into V^T,
// transposed on the way, with each group of 8 keys stored in the order
// 0 2 4 6 1 3 5 7: the S accumulator holds keys 2t and 2t + 1 of a group
// where a TF32 A fragment takes columns t and t + 4, so P goes from the
// accumulator to the A registers of P V as it is.  A thread pass writes the
// lo tiles.  Per kv tile t:
//   1. S_t = Q K_t^T as 3 x D/8 `wgmma.m64n64k8`, Q and K from shared memory;
//      meanwhile the warpgroup writes V_t^T lo;
//   2. once every warp's S_t is done, K_{t+1} is fetched into the free tile;
//   3. masks S_t in registers from the accumulator's (row, column) map (row
//      16 warp + lane/4 (+8), column 8 j + 2 (lane % 4) (+1)) and takes the
//      online softmax, two xor shuffles per row; p is hi, and lo is one
//      subtraction;
//   4. P V_t as 3 x 8 `wgmma.m64nDk8`, P from registers; meanwhile the
//      warpgroup writes K_{t+1} lo; then O = corr O + P V_t;
//   5. once every warp's P V is done, V_{t+1} is fetched.  Past the last
//      tile the copies fill zeros: one path for every tile (ptxas 12.8
//      crashes on this loop with the copies behind a branch at D = 32).
// The copies run while the tensor cores work; the softmax (step 3) does not
// overlap them.  No `wgmma` sits on a path that depends on the thread
// (ptxas serialises those).  Two warpgroups ping-ponging, a producer warp
// with TMA and double-buffered tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int BQ = 64;     // query rows per block: one warpgroup's wgmma M
constexpr int BK = 64;     // keys per kv tile
constexpr int NT = 128;    // threads per block: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == BK, "the Q, K and V^T tiles share one size: [64, D], [D, 64]");

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int H, int KV, int Sq, int Sk, int causal, float scale) {
  constexpr uint32_t TILE = BQ * D * 4;  // bytes of each tile: Q, K [64, D]; V^T [D, 64]
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle is a function of the address: align the tiles to 1024 bytes
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_hi = base, q_lo = base + TILE, k_hi = base + 2 * TILE,
                 k_lo = base + 3 * TILE, v_hi = base + 4 * TILE, v_lo = base + 5 * TILE;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);  // native GQA: no repeated K/V
  // causal: the longest tiles (the last query rows) go first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;

  const size_t q_row = (size_t)H * D, k_row = (size_t)KV * D;
  const float* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * Sk * k_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Sk * k_row + (size_t)kvh * D;
  float* ob = o + (size_t)b * Sq * q_row + (size_t)h * D;

  // causal: tiles past the block's last query row hold only masked keys
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  // this thread's two rows of the block's 64, and their columns
  const int row[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  const int col = 2 * (lane % 4);

  float m[2] = {-INFINITY, -INFINITY};    // running max, natural units
  float ml[2] = {-INFINITY, -INFINITY};   // m log2(e), rounded once: the exponent's base
  float l[2] = {0.f, 0.f};
  float corr[2];                   // the rescale of O at this tile
  float acc[D / 2], pv[D / 2];     // O; this tile's P V
  float s[BK / 2], plo[BK / 2];    // S, then P (= hi); P lo
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = pv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  // Q and K tiles [64, D]: thread (rg, cu) = (tid / 8, tid % 8) takes rows
  // rg + 16 a (a < 4) and 16-byte units cu + 8 j (j < D / 32), so a warp
  // reads 4 rows of 128 contiguous bytes and writes 32 distinct banks, and
  // every shared address is the thread's base plus a constant.  K_t goes
  // by cp.async into K hi; a thread splits the units it copied itself, so
  // its own cp.async wait is enough before it does.
  const int rg = tid / 8, cu = tid % 8;
  const uint32_t qk_base = at<BQ>(rg, cu);
  auto load_k = [&](int t) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int key = t * BK + rg + 16 * a;
      const bool ok = key < k_end;
      const float* g = kb + (size_t)(ok ? key : 0) * k_row + 4 * cu;
#pragma unroll
      for (int j = 0; j < D / 32; ++j)
        cp_async16(k_hi + qk_base + j * (BK * 128) + a * (16 * 128), g + 32 * j, ok);
    }
    cp_async_commit();
  };
  auto split_k = [&]() {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const uint32_t off = qk_base + j * (BK * 128) + a * (16 * 128);
        sts4(k_lo + off, tf32_lo(lds4(k_hi + off)));
      }
  };
  // V_t^T: row d, position p (unit p / 4, float p % 4) holds key
  // 8 (p / 8) + 2 (p % 4) + (p / 4) % 2.  Lane (dd, pp) = (lane % 8,
  // lane / 8) of warp w takes units u = 4 c + w (c < 4) at position 4 u + pp
  // of rows dd + 8 j (j < D / 8): one key a unit, so a warp reads 4 rows of
  // 32 contiguous bytes and writes 32 distinct banks.
  const int dd = lane & 7, pp = lane >> 3;
  auto load_v = [&](int t) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int u = 4 * c + warp;
      const int key = t * BK + 8 * (u / 2) + 2 * pp + (u & 1);
      const bool ok = key < k_end;
      const float* g = vb + (size_t)(ok ? key : 0) * k_row + dd;
      const uint32_t dst = v_hi + (c / 2) * (D * 128) + dd * 128 + (((u & 7) ^ dd) << 4) + 4 * pp;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) cp_async4(dst + j * (8 * 128), g + 8 * j, ok);
    }
    cp_async_commit();
  };
  // V^T lo: thread tid takes unit tid % 16 of rows tid / 16 + 8 i
  const uint32_t vt_base = at<D>(tid / 16, tid % 16);
  auto split_v = [&]() {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const uint32_t off = vt_base + i * (8 * 128);
      sts4(v_lo + off, tf32_lo(lds4(v_hi + off)));
    }
  };
  // 1. S = (lo hi' + hi lo') + hi hi' over D / 8 steps of 8
  auto start_s = [&]() {
#pragma unroll
    for (int pr = 0; pr < 3; ++pr)
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t off = (kk / 4) * (BQ * 128) + (kk % 4) * 32;
        wgmma_ss_n64(s, desc((pr == 0 ? q_lo : q_hi) + off),
                     desc((pr == 1 ? k_lo : k_hi) + off), pr > 0 || kk > 0);
      }
    wgmma_commit();
  };
  // 4. P V = (lo hi' + hi lo') + hi hi' over the tile's 8 steps of 8 keys,
  // into a zeroed accumulator
  auto start_pv = [&]() {
#pragma unroll
    for (int pr = 0; pr < 3; ++pr)
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        uint32_t a[4];
        if (pr == 0) a_frag(plo, kk, a);
        else a_frag(s, kk, a);
        wgmma_rs<D>(pv, a,
                    desc((pr == 1 ? v_lo : v_hi) + (kk / 4) * (D * 128) + (kk % 4) * 32),
                    pr > 0 || kk > 0);
      }
    wgmma_commit();
  };
  // 3. mask, online softmax, P = hi + lo
  auto softmax = [&](int t) {
    const int k0 = t * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + col + (i & 1);
      if (edge && (key >= Sk || (causal && key > row[(i >> 1) & 1]))) s[i] = -INFINITY;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      const float mn = fmaxf(m[rr], mt[rr]);
      const float mln = mn == -INFINITY ? 0.f : mn * LOG2E;  // a row with no key yet
      corr[rr] = ex2(ml[rr] - mln);
      m[rr] = mn;
      ml[rr] = mln;
      l[rr] *= corr[rr];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ex2(fmaf(s[i], LOG2E, -ml[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
      plo[i] = tf32_lo(s[i]);
    }
  };

  // Q, scaled, then split into its two tiles; it stays for the whole loop
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const int r = q0 + rg + 16 * a;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < Sq) x = *reinterpret_cast<const float4*>(qb + (size_t)r * q_row + 4 * cu + 32 * j);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      const uint32_t off = qk_base + j * (BQ * 128) + a * (16 * 128);
      sts4(q_hi + off, x);
      sts4(q_lo + off, tf32_lo(x));
    }
  load_k(0);
  load_v(0);
  cp_async_wait<1>();  // K_0
  split_k();
  for (int t = 0; t < n_tiles; ++t) {
    fence_async_smem();
    __syncthreads();  // K_t hi and lo (and Q) from every thread
    pin(s);
    wgmma_fence();
    start_s();
    cp_async_wait<0>();  // V_t
    __syncthreads();     // ... from every thread
    split_v();           // while the tensor cores take S_t
    fence_async_smem();
    wgmma_wait<0>();
    pin(s);
    __syncthreads();  // every warp's S_t is done: K's tiles are free; V_t^T lo is in
    load_k(t + 1);  // past the last tile: zeros (step 5 in the notes above)
    softmax(t);
    pin(pv);
    wgmma_fence();
    start_pv();
    cp_async_wait<0>();  // K_{t+1}
    split_k();           // while the tensor cores take P V_t
    wgmma_wait<0>();
    pin(pv);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], pv[i]);
    __syncthreads();  // every warp's P V_t is done: V's tiles are free
    load_v(t + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    if (lse != nullptr && col == 0 && row[rr] < Sq)
      lse[(size_t)bh * Sq + row[rr]] = (ml[rr] + log2f(l[rr])) * 0.6931471805599453f;
    l[rr] = 1.f / fmaxf(l[rr], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int rr = (i >> 1) & 1;
    if (row[rr] < Sq)
      *reinterpret_cast<float2*>(ob + (size_t)row[rr] * q_row + 8 * (i / 4) + col) =
          make_float2(acc[i] * l[rr], acc[i + 1] * l[rr]);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   int B, int H, int KV, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = (size_t)6 * BQ * D * 4 + 1024;  // six tiles + alignment
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_f32<D><<<grid, NT, bytes, stream>>>(q, k, v, o, lse, H, KV, Sq, Sk, causal,
                                                scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes; lse is a float32 [B, H, Sq] buffer or
// null.  Returns a cudaError_t; 0 on success.
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                                         void* o, void* lse, int B, int H, int KV, int Sq,
                                         int Sk, int D, int causal, float scale, void* stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(o);
  float* lt = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(qt, kt, vt, ot, lt, B, H, KV, Sq, Sk, causal, scale, s);
    case 64: return launch<64>(qt, kt, vt, ot, lt, B, H, KV, Sq, Sk, causal, scale, s);
    case 128: return launch<128>(qt, kt, vt, ot, lt, B, H, KV, Sq, Sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
