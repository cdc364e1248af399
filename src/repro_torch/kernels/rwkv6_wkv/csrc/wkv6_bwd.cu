// Gradient of the WKV6 recurrence (RWKV6 "Finch" time mixing) for Hopper
// (sm_90a), float32 or bfloat16 inputs, float32 arithmetic and state, in the
// chunked form whose matrix products run on the tensor cores.
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
// The chunked form, in wkv6.cu's conventions (its header): chunks of C = 64
// steps, each cut into sub-chunks of SC = 8; d(j, i) = w_{j+1} ... w_{i-1};
// S0 the state at a chunk's start and dSe the gradient of its last state;
// A the forward's intra-chunk matrix, A_ij = sum_k r_i k_j d(j, i) for j < i
// and the bonus sum_k u r_i k_i on its diagonal; B_ij = dy_i . v_j.  Within
// a chunk
//
//     dv_i = dSe^T (k_i d(i,C))  + sum_{l>=i} A_li dy_l
//     dr_i = d(-1,i) (S0 dy_i)   + sum_{j<i} B_ij k_j d(j,i) + u k_i B_ii
//     dk_i = d(i,C) (dSe v_i)    + sum_{l>i} B_li r_l d(i,l) + u r_i B_ii
//     dS0  = d(-1,C) dSe + sum_l (r_l d(-1,l)) dy_l^T      (the carry back)
//     dw_i = sum_v dS_i S_{i-1}
//
// so a chunk is a handful of matrix products, and only the states carry
// from chunk to chunk: T/C dependent steps each way, not T.
//
// Where the trouble lies, and what this kernel does about it.
// - Decays are products, never quotients.  The model rounds exp(-exp(x)) to
//   bfloat16, so w is exactly 0 and exactly 1 at times (models/rwkv6.py).  A
//   pair (i, j) in sub-chunks a > b is split, as wkv6.cu splits it, into a
//   per-row factor (the decay within a from its start, or within b to its
//   end), the whole sub-chunks between (the table F) and a per-column factor,
//   each <= 1.  The two row halves of a 16-row tile share one column operand:
//   the half whose sub-chunks lie a sub-chunk further off takes that
//   sub-chunk's product G on its row after the sum.  A pair within one
//   sub-chunk is summed on the CUDA cores, its decay multiplied up step by
//   step, and the same walk gives the row's own factor.  Split at the chunk's
//   start instead, the k side is k_j / d(-1, j + 1), which overflows, or is
//   0/0, past a zero.
// - dw is computed directly, never divided by w.  The identity that other
//   chunked implementations use gives only w_i dw_i (differences of r dr and
//   k dk over a cumulative sum); dividing by w_i recovers nothing where w_i =
//   0 and cancels where it is tiny (the model's decays reach e^-54.6).  Here
//   dw_i = sum_v dS_i S_{i-1} is expanded at i's sub-chunk a, from the state
//   at its start Ss_a and the gradient at its end dSe_a:
//
//     dw_i = Wl_i Wr_i P_a + Wr_i sum_{j<i} k_j d(j,i) X_j + Wl_i sum_{l>i} r_l d(i,l) Y_l
//            + sum_{j<i<l} k_j r_l d(j,i) d(i,l) B_lj          (j, l in a)
//
//   with Wl_i, Wr_i the decay within a to and from i, P_a = sum_v Ss_a dSe_a,
//   X_j = dSe_a v_j and Y_l = Ss_a dy_l.  X and Y are dk's and dr's sums
//   before their row factors (dk_j = Wr_j X_j + its pairs, dr likewise), so
//   the products give them; P comes from Ss and dSe carried a sub-chunk at a
//   time on the tensor cores (Ss_{a+1} = G_a Ss_a + Kl_a^T V_a forward,
//   dSe_{a-1} = G_a dSe_a + Rl_a^T dY_a back, meeting in the middle); the
//   rest is 8 x 8 work per channel and sub-chunk on the CUDA cores.
// - No atomics: two runs give equal bits.  A block holds a whole (b, h), so
//   dr, dk, dv and dw are complete in it; only du sums over the batch, each
//   block writing its part for a second kernel to sum in batch order.
// - The tensor core truncates each sum into its accumulator.  Every product
//   is summed in zeroed fragments (at most 16 k-steps of 8 a sum), its hi
//   terms and its lo terms apart, and added in float32 after (wkv6.cu's
//   3xTF32: a float32 operand x is split into hi, the top of x the tensor
//   core reads, and lo = x - hi; a product is lo hi' + hi lo' + hi hi').  v
//   and dy in bfloat16 are exact in TF32, so products with them take two
//   terms, and B = dY V^T one.  One TF32 product misses the float32 limit
//   28-79x (tests/test_torch_wkv6_bwd.py emulates each choice).
// - Ragged T: w past the end is taken as 1 and the missing rows of r, k, v
//   and dy as 0, as the forward does, so the padded steps leave the states
//   as they are.
// - Occupancy: the block holds its chunk's inputs (twice where it fits, the
//   next chunk's landing under this one's work: all but float32 at K 64),
//   the decayed r and k, S0, dS, A and B in shared memory (210 KB at K 64 in
//   bfloat16, 205 KB in float32), so one block of 8 warps runs on an SM; at
//   16 warps ptxas's 128 registers a thread did not hold the kernel and it
//   spilled (repro_wkv6_bwd_occupancy reports the launch; chip_smoke's
//   wkv6_bwd_build_report prints it with the registers and HMMA count).
//
// What bounds it on an H100: per (b, t, h) about 6 K V multiply-adds of
// essential work against 5 K values read and 4 K written; at rwkv6-7b's
// heads (K 64) in bfloat16, as 3xTF32 on the tensor cores, the bytes bound it
// (chip_smoke.wkv6_bwd_kernel_phase).  This kernel does more: ~10 products of
// C K V multiply-adds a chunk on the tensor cores, each operand built and
// split on the CUDA cores, and the pairs inside sub-chunks there; what holds
// it back is latency, one block an SM walking its chunks through barriers.
//
// Design.  One block of 8 warps per (b, h): B H blocks.  The block first runs
// the state pass over the chunks, S <- F_TOT S + (Kl F_SUF)^T V, keeping each
// chunk's start but the first in a float32 workspace (B H (ceil(T/C) - 1) K
// K; the last chunk's start stays in shared memory).  Then it walks the
// chunks from the last, dS in shared memory.  Per chunk:
//   0. r, k, w, v, dy of the chunk have arrived by cp.async (w's missing
//      rows set to 1), and its S0 from the workspace; the next chunk's
//      inputs are asked for, into the other buffer where there are two;
//   1. threads 0 .. 2K - 1: Rl_i = r_i d(s_a - 1, i), Kl_j = k_j d(j, e_b),
//      the sub-chunk products G and the table F; the block's second half:
//      A's diagonal blocks and the bonus (wkv6.cu's pair pass);
//   2. A between sub-chunks and B = dY V^T, on the tensor cores;
//   3. each warp: its tiles of dv (out), of P, of the carry dS0 and of Y and
//      X, all on the tensor cores; dS <- the carry once dSe is read;
//   4. the next chunk's S0 is asked for; Y and X into Rl's and Kl's space;
//      then thread (a, c): channel c of sub-chunk a, its 8 rows of dr, dk
//      and dw (out) and du's part, a thread's items (two at K 64) side by side.
// Five barriers a chunk; nothing crosses blocks but du.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int C = 64;          // time steps per chunk
constexpr int SC = 8;          // time steps per sub-chunk
constexpr int NSC = C / SC;    // sub-chunks per chunk
constexpr int AS = C + 4;      // row stride of A and B (floats): fragment reads hit 32 banks

// F's rows: the decay of whole sub-chunks, per channel (as wkv6.cu)
constexpr int F_PRE = 0;          // F_PRE + a: G_0 ... G_{a-1}
constexpr int F_SUF = NSC;        // F_SUF + b: G_{b+1} ... G_{NSC-1}
constexpr int F_TOT = 2 * NSC;    // the whole chunk
constexpr int F_BETWEEN = F_TOT + 1;  // + a (a - 1) / 2 + b for b < a: G_{b+1} ... G_{a-1}
constexpr int F_ONE = F_BETWEEN + NSC * (NSC - 1) / 2;  // all 1
constexpr int F_ZERO = F_ONE + 1;                        // all 0
constexpr int F_ROWS = F_ZERO + 1;

__device__ __forceinline__ int between(int b, int a) { return F_BETWEEN + a * (a - 1) / 2 + b; }

template <typename T, int K>
struct Cfg {
  static constexpr int NW = 8;                // warps
  static constexpr int NT = 32 * NW;          // threads
  static constexpr int RS = K + 4;            // row stride of float arrays [.][K]
  static constexpr int RT = K + 16 / (int)sizeof(T);  // row stride of the raw inputs
  static constexpr int NN = K / 16;           // n8 tiles a warp takes of dr, dk, dv
  static constexpr int WPR = K / 8 / NN;      // warps per 16-row tile of dr, dk, dv
  static constexpr int TPW = K * K / 128 / NW;  // tiles of the K x V state a warp takes
  static constexpr int NVT = K / 8;           // n8 tiles across V
  static constexpr int BT = 32 / NW;          // tiles of B a warp takes
  static constexpr int ATILE = 16 / NW;       // tiles of A between sub-chunks a warp takes
  static_assert(WPR * 4 == NW && TPW * NW == (K / 16) * NVT, "tiles spread over the warps");
  static constexpr size_t raw = (size_t)C * RT * sizeof(T);
  // r, k, w, v, dy within a buffer of the chunk's inputs
  static constexpr size_t r = 0, k = r + raw, w = k + raw, v = w + raw, dy = v + raw;
  static constexpr size_t raw5 = 5 * raw;
  static constexpr size_t rest = (size_t)(2 * C * RS + 2 * K * RS + 2 * C * AS + F_ROWS * K +
                                          NSC * K + K + (NVT / TPW) * NSC * K) * 4;
  // a second buffer where it fits (all but float32 at K 64): the next chunk's
  // inputs land under this chunk's work
  static constexpr bool DB = 2 * raw5 + rest <= 232448;
  static constexpr size_t rl = (DB ? 2 : 1) * raw5;
  static constexpr size_t kl = rl + (size_t)C * RS * 4;
  static constexpr size_t s0 = kl + (size_t)C * RS * 4;
  static constexpr size_t ds = s0 + (size_t)K * RS * 4;
  static constexpr size_t a = ds + (size_t)K * RS * 4;
  static constexpr size_t bm = a + (size_t)C * AS * 4;
  static constexpr size_t f = bm + (size_t)C * AS * 4;
  static constexpr size_t g = f + (size_t)F_ROWS * K * 4;
  static constexpr size_t u = g + (size_t)NSC * K * 4;
  static constexpr size_t pp = u + (size_t)K * 4;  // P's parts, [NVT / TPW][NSC][K]
  static constexpr size_t bytes = pp + (size_t)(NVT / TPW) * NSC * K * 4;
  static_assert(bytes == rl + rest, "the layout adds up");
  static_assert((NVT / TPW) * NSC * K >= NT, "P's space holds du's parts at the end");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

// n consecutive values from 16-byte (float) or 8-byte (bfloat16) aligned
// shared memory, as float32
template <int N>
__device__ __forceinline__ void load_n(const float* s, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(s + i);
    out[i] = a.x; out[i + 1] = a.y; out[i + 2] = a.z; out[i + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* s, float* out) {
  static_assert(N % 4 == 0, "whole 8-byte reads");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(s + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    out[i] = f0.x; out[i + 1] = f0.y; out[i + 2] = f1.x; out[i + 3] = f1.y;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The 3xTF32 split: hi is what the tensor core reads of x (the low 13
// mantissa bits cleared), lo = x - hi exactly.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// D[16 x 8] += A[16 x 8] B[8 x 8], TF32 in, float32 out.  Fragments, for
// g = lane / 4 and t = lane % 4: a0 A[g][t], a1 A[g+8][t], a2 A[g][t+4],
// a3 A[g+8][t+4]; b0 B[t][g], b1 B[t+4][g]; d0 D[g][2t], d1 D[g][2t+1],
// d2 D[g+8][2t], d3 D[g+8][2t+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (a0..a3 given as float32), split into hi and lo.
struct Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// The 3xTF32 product: dh += a.hi b.hi and dl += a.lo b.hi + a.hi b.lo, the
// small terms in their own accumulator.  AE / BE: the operand's values are
// exact in TF32 (bfloat16 v and dy), and its lo terms are 0.
template <bool AE, bool BE>
__device__ __forceinline__ void mma3(float (&dh)[4], float (&dl)[4], const Frag& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  if (!AE) mma(dl, a.lo, bh0, bh1);
  if (!BE) mma(dl, a.hi, bl0, bl1);
  mma(dh, a.hi, bh0, bh1);
}

// k-steps [s0, s1) of 8 of a warp's product D[16 x 8 NN] += A B into the
// pairs (dh, dl): fa(row, kx) gives A at the tile's row 0..15 and k index
// kx; fb(kx, n) gives B at k index kx and this lane's column g of n8 tile n.
template <bool AE, bool BE, int NN, typename FA, typename FB>
__device__ __forceinline__ void mma_steps(float (&dh)[NN][4], float (&dl)[NN][4], int s0,
                                          int s1, FA fa, FB fb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    const int c0 = 8 * s + t4, c1 = c0 + 4;
    Frag a;
    a.set(fa(g, c0), fa(g + 8, c0), fa(g, c1), fa(g + 8, c1));
#pragma unroll
    for (int n = 0; n < NN; ++n) mma3<AE, BE>(dh[n], dl[n], a, fb(c0, n), fb(c1, n));
  }
}

template <int NN>
__device__ __forceinline__ void zero(float (&dh)[NN][4], float (&dl)[NN][4]) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[n][e] = dl[n][e] = 0.f;
}

// Sums over the 8 lanes of a group (lane bits 0-2 = kg) of 8 values each:
// lane kg returns the sum of everyone's v[kg] (three halving exchanges).
__device__ __forceinline__ float reduce8(const float (&v)[8], int kg) {
  float a4[4], a2[2];
  const bool u4 = kg & 4, u2 = kg & 2, u1 = kg & 1;
#pragma unroll
  for (int x = 0; x < 4; ++x)
    a4[x] = (u4 ? v[x + 4] : v[x]) + __shfl_xor_sync(FULL, u4 ? v[x] : v[x + 4], 4);
#pragma unroll
  for (int x = 0; x < 2; ++x)
    a2[x] = (u2 ? a4[x + 2] : a4[x]) + __shfl_xor_sync(FULL, u2 ? a4[x] : a4[x + 2], 2);
  return (u1 ? a2[1] : a2[0]) + __shfl_xor_sync(FULL, u1 ? a2[0] : a2[1], 1);
}

// One channel's walk over a chunk (w past its end already 1): FWD, dst_i =
// x_i w_s ... w_{i-1} from its sub-chunk's start s, and G[a][kk] = G_a,
// each sub-chunk's product; else dst_i = x_i w_{i+1} ... w_{e-1} to its end.
// dst null: G alone.
template <bool FWD, int K, int RT, int RS, typename T>
__device__ __forceinline__ void walk(const T* x, const T* w, float* dst, int kk, float* G) {
#pragma unroll 1
  for (int a = 0; a < NSC; ++a) {
    float xv[SC], wv[SC];
#pragma unroll
    for (int y = 0; y < SC; ++y) {
      xv[y] = to_f(x[(a * SC + y) * RT + kk]);
      wv[y] = to_f(w[(a * SC + y) * RT + kk]);
    }
    float c = 1.f;
#pragma unroll
    for (int y = 0; y < SC; ++y) {
      const int i = FWD ? y : SC - 1 - y;
      if (dst != nullptr) dst[(a * SC + i) * RS + kk] = xv[i] * c;
      c *= wv[i];
    }
    if (FWD) G[a * K + kk] = c;
  }
}

// F from G, one channel (after its own walk wrote G[.][kk])
template <int K>
__device__ __forceinline__ void f_table(const float* G, float* F, int kk) {
  float gs[NSC];
#pragma unroll
  for (int a = 0; a < NSC; ++a) gs[a] = G[a * K + kk];
  float c = 1.f;
#pragma unroll
  for (int a = 0; a < NSC; ++a) {
    F[(F_PRE + a) * K + kk] = c;
    c *= gs[a];
  }
  F[F_TOT * K + kk] = c;
  F[F_ONE * K + kk] = 1.f;
  F[F_ZERO * K + kk] = 0.f;
  c = 1.f;
#pragma unroll
  for (int a = NSC - 1; a >= 0; --a) {
    F[(F_SUF + a) * K + kk] = c;
    c *= gs[a];
  }
#pragma unroll
  for (int bs = 0; bs < NSC - 1; ++bs) {
    c = 1.f;
#pragma unroll
    for (int a = bs + 1; a < NSC; ++a) {
      F[between(bs, a) * K + kk] = c;
      c *= gs[a];
    }
  }
}

// A warp's tiles of the K x V product sum_i (X_i F[frow + i / SC])[k] Y_i[v]
// over a chunk (the state pass with Kl, F_SUF and v; the carry with Rl,
// F_PRE and dy), in zeroed pairs of accumulators, each summed once.
template <typename T, int K>
__device__ __forceinline__ void state_product(const float* X, const float* F, int frow,
                                              const T* Y, float (&out)[Cfg<T, K>::TPW][4]) {
  using L = Cfg<T, K>;
  constexpr int TPW = L::TPW, RS = L::RS, RT = L::RT;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4;
  const int mt = (warp * TPW) / L::NVT, n0 = (warp * TPW) % L::NVT;
  const int m0 = 16 * mt;
  float dh[TPW][4], dl[TPW][4];
  zero(dh, dl);
  mma_steps<false, sizeof(T) == 2, TPW>(
      dh, dl, 0, C / 8,
      [&](int row, int i) { return X[i * RS + m0 + row] * F[(frow + i / SC) * K + m0 + row]; },
      [&](int i, int n) { return to_f(Y[i * RT + 8 * (n0 + n) + g]); });
#pragma unroll
  for (int q = 0; q < TPW; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[q][e] = dh[q][e] + dl[q][e];
}

template <typename T, int K>
__global__ void __launch_bounds__(Cfg<T, K>::NT, 1)
wkv6_bwd_main(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ w, const T* __restrict__ u, const float* __restrict__ s0,
              const T* __restrict__ dy, const float* __restrict__ ds_out, T* __restrict__ dr,
              T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dw,
              float* __restrict__ du_part, float* __restrict__ dstate,
              float* __restrict__ ckpt, int T_len, int H) {
  using L = Cfg<T, K>;
  constexpr int NT = L::NT, NW = L::NW, RS = L::RS, RT = L::RT, NN = L::NN, TPW = L::TPW;
  constexpr int KG = K / 8;                  // channels per thread in the pair pass
  constexpr int EPC = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr bool EX = sizeof(T) == 2;        // bfloat16 v and dy are exact in TF32

  extern __shared__ __align__(16) uint8_t smem[];
  T *raw_r, *raw_k, *raw_w, *raw_v, *raw_dy;  // the inputs of the chunk at hand
  auto use_buf = [&](int b) {
    uint8_t* q = smem + b * L::raw5;
    raw_r = reinterpret_cast<T*>(q + L::r);
    raw_k = reinterpret_cast<T*>(q + L::k);
    raw_w = reinterpret_cast<T*>(q + L::w);
    raw_v = reinterpret_cast<T*>(q + L::v);
    raw_dy = reinterpret_cast<T*>(q + L::dy);
  };
  float* Rl = reinterpret_cast<float*>(smem + L::rl);
  float* Kl = reinterpret_cast<float*>(smem + L::kl);
  float* S0 = reinterpret_cast<float*>(smem + L::s0);
  float* dS = reinterpret_cast<float*>(smem + L::ds);
  float* A = reinterpret_cast<float*>(smem + L::a);
  float* Bm = reinterpret_cast<float*>(smem + L::bm);
  float* F = reinterpret_cast<float*>(smem + L::f);
  float* G = reinterpret_cast<float*>(smem + L::g);
  float* su = reinterpret_cast<float*>(smem + L::u);
  float* Pp = reinterpret_cast<float*>(smem + L::pp);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const size_t step = (size_t)H * K;          // elements between time steps
  const size_t base = ((size_t)b * T_len * H + h) * K;
  const int nch = (T_len + C - 1) / C;

  // a chunk's inputs into buffer b (the state pass needs k, w, v only); w's
  // missing rows 1
  auto load_chunk = [&](int t0, bool all, int b) {
    uint8_t* q = smem + b * L::raw5;
    T* br = reinterpret_cast<T*>(q + L::r);
    T* bk = reinterpret_cast<T*>(q + L::k);
    T* bw = reinterpret_cast<T*>(q + L::w);
    T* bv = reinterpret_cast<T*>(q + L::v);
    T* bdy = reinterpret_cast<T*>(q + L::dy);
    const int nt = min(C, T_len - t0);
    constexpr int PR = K / EPC;
    for (int i = tid; i < C * PR; i += NT) {
      const int tt = i / PR, off = (i - tt * PR) * EPC;
      const bool ok = tt < nt;
      const size_t gi = base + (size_t)(ok ? t0 + tt : t0) * step + off;
      const int si = tt * RT + off;
      cp_async16(&bk[si], k + gi, ok);
      cp_async16(&bv[si], v + gi, ok);
      if (ok) {
        cp_async16(&bw[si], w + gi, true);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) bw[si + e] = from_f<T>(1.f);
      }
      if (all) {
        cp_async16(&br[si], r + gi, ok);
        cp_async16(&bdy[si], dy + gi, ok);
      }
    }
  };
  // a K x K float32 state into S0's rows
  auto load_state = [&](const float* src) {
    for (int i = tid; i < K * K / 4; i += NT) {
      const int row = i / (K / 4), c = (i % (K / 4)) * 4;
      cp_async16(&S0[row * RS + c], src + (size_t)row * K + c, true);
    }
  };

  // the inputs of step i: the state pass's chunks 0 .. nch - 2, then the
  // chunks from the last; each fetched a step ahead into the other buffer
  // where there are two, else at its step's start
  auto fetch = [&](int i, int b) {
    const bool back = i >= nch - 1;
    load_chunk((back ? 2 * nch - 2 - i : i) * C, back, b);
    cp_async_commit();
  };

  // ---- the state pass: each chunk's start, but the first, into the workspace
  if (tid < K) su[tid] = to_f(u[(size_t)h * K + tid]);
  load_state(s0 + (size_t)bh * K * K);
  fetch(0, 0);
  int seq = 0, buf = 0;  // the step and its input buffer
  for (int ch = 0; ch + 1 < nch; ++ch, ++seq) {
    cp_async_wait_all();
    __syncthreads();
    use_buf(buf);
    if (L::DB) fetch(seq + 1, buf ^ 1);
    if (tid < K) {
      walk<true, K, RT, RS>(raw_k, raw_w, nullptr, tid, G);
      f_table<K>(G, F, tid);
    } else if (tid < 2 * K) {
      walk<false, K, RT, RS>(raw_k, raw_w, Kl, tid - K, G);
    }
    __syncthreads();
    float up[TPW][4];
    state_product<T, K>(Kl, F, F_SUF, raw_v, up);
    const int mt = (warp * TPW) / L::NVT, n0 = (warp * TPW) % L::NVT;
    const int m0 = 16 * mt + g, m1 = m0 + 8;
    const float tot0 = F[F_TOT * K + m0], tot1 = F[F_TOT * K + m1];
    float* out = ckpt + ((size_t)bh * (nch - 1) + ch) * K * K;
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      const int cc = 8 * (n0 + q) + 2 * t4;
      float* p0 = &S0[m0 * RS + cc];
      float* p1 = &S0[m1 * RS + cc];
      p0[0] = fmaf(tot0, p0[0], up[q][0]);
      p0[1] = fmaf(tot0, p0[1], up[q][1]);
      p1[0] = fmaf(tot1, p1[0], up[q][2]);
      p1[1] = fmaf(tot1, p1[1], up[q][3]);
      store2(out + (size_t)m0 * K + cc, p0[0], p0[1]);
      store2(out + (size_t)m1 * K + cc, p1[0], p1[1]);
    }
    __syncthreads();  // the next chunk's inputs may land
    if (!L::DB) fetch(seq + 1, 0);
    buf ^= L::DB;
  }

  // ---- the chunks from the last: dS the gradient of the chunk's last state
  for (int i = tid; i < K * K; i += NT) {
    const int row = i / K, c = i % K;
    dS[row * RS + c] = ds_out != nullptr ? ds_out[(size_t)bh * K * K + i] : 0.f;
  }
  float du_acc = 0.f;  // du's part for channel tid % K (the epilogue's items)

  for (int ch = nch - 1; ch >= 0; --ch, ++seq) {
    const int t0 = ch * C, nt = min(C, T_len - t0);
    cp_async_wait_all();  // this chunk's inputs and S0
    __syncthreads();
    use_buf(buf);
    if (L::DB && ch > 0) fetch(seq + 1, buf ^ 1);

    // ---- 1. the decays and F; A's diagonal blocks and the bonus
    if (tid < K) {
      walk<true, K, RT, RS>(raw_r, raw_w, Rl, tid, G);
      f_table<K>(G, F, tid);
    } else if (tid < 2 * K) {
      walk<false, K, RT, RS>(raw_k, raw_w, Kl, tid - K, G);
    }
    if (tid >= NT / 2) {
      // the pair pass (the block's second half): thread (pr, kg) owns
      // channels [kg KG, kg KG + KG) of rows q and 7 - q of a sub-chunk: 7
      // pairs; q is one per warp, so no branch diverges
      const int pt = tid - NT / 2, kg = pt % 8;
#pragma unroll 1
      for (int it = 0; it < 256 / (NT / 2); ++it) {
        const int pr = pt / 8 + it * (NT / 16);
        const int a = pr % NSC, q = pr / NSC;
        const int i1 = a * SC + q, i2 = a * SC + SC - 1 - q;
        float rd[KG], kx[KG], part[8], b2 = 0.f;
        {  // the bonus of rows i1 (part[7]) and i2 (b2)
          float uu[KG], r2[KG];
          load_n<KG>(&su[kg * KG], uu);
          load_n<KG>(&raw_r[i1 * RT + kg * KG], rd);
          load_n<KG>(&raw_k[i1 * RT + kg * KG], kx);
          part[7] = 0.f;
#pragma unroll
          for (int x = 0; x < KG; ++x) part[7] = fmaf(uu[x] * rd[x], kx[x], part[7]);
          load_n<KG>(&raw_r[i2 * RT + kg * KG], r2);
          load_n<KG>(&raw_k[i2 * RT + kg * KG], kx);
#pragma unroll
          for (int x = 0; x < KG; ++x) b2 = fmaf(uu[x] * r2[x], kx[x], b2);
        }
        // row i1 takes the first q pairs, row i2 the other SC - 1 - q: for
        // j = i - m, rd = r_i d(j, i), multiplied up by w_{j+1} as j falls
        int i = i1, m = 0;
#pragma unroll
        for (int x2 = 0; x2 < SC - 1; ++x2) {
          if (x2 == q) {
            i = i2;
            m = 0;
            load_n<KG>(&raw_r[i2 * RT + kg * KG], rd);
          }
          const int j = i - ++m;
          if (m >= 2) {
            float wx[KG];
            load_n<KG>(&raw_w[(j + 1) * RT + kg * KG], wx);
#pragma unroll
            for (int x = 0; x < KG; ++x) rd[x] *= wx[x];
          }
          load_n<KG>(&raw_k[j * RT + kg * KG], kx);
          part[x2] = 0.f;
#pragma unroll
          for (int x = 0; x < KG; ++x) part[x2] = fmaf(rd[x], kx[x], part[x2]);
        }
        const float sum = reduce8(part, kg);
        b2 += __shfl_xor_sync(FULL, b2, 1);
        b2 += __shfl_xor_sync(FULL, b2, 2);
        b2 += __shfl_xor_sync(FULL, b2, 4);
        A[kg == 7 ? i1 * AS + i1
                  : (kg < q ? i1 * AS + i1 - 1 - kg : i2 * AS + i2 - 1 - (kg - q))] = sum;
        if (kg == 0) A[i2 * AS + i2] = b2;
        const int j = a * SC + kg;  // zeros above the diagonal
        if (j > i1) A[i1 * AS + j] = 0.f;
        if (j > i2) A[i2 * AS + j] = 0.f;
        if (a % 2 == 0) {  // and in the next sub-chunk's columns, which dv reads too
          A[i1 * AS + j + SC] = 0.f;
          A[i2 * AS + j + SC] = 0.f;
        }
      }
    }
    __syncthreads();  // Rl, Kl, F, G and A's diagonal blocks are in

    // ---- 2. A between sub-chunks (tile tau = p^2 + b: rows 16 p .. + 15
    // against sub-chunk b <= 2 p, the between-factor on the row's side, as
    // wkv6.cu) and B = dY V^T whole
#pragma unroll
    for (int x = 0; x < L::ATILE; ++x) {
      const int tau = warp + NW * x;
      const int p = tau < 1 ? 0 : (tau < 4 ? 1 : (tau < 9 ? 2 : 3));
      const int bsub = tau - p * p;
      const int ri = 16 * p, cj = bsub * SC;
      const int a0 = 2 * p, a1 = 2 * p + 1;
      const int f0 = K * (bsub >= a0 ? F_ZERO : (bsub == a0 - 1 ? F_ONE : between(bsub, a0)));
      const int f1 = K * (bsub == a1 - 1 ? F_ONE : between(bsub, a1));
      float ah[1][4], al[1][4];
      zero(ah, al);
      mma_steps<false, false, 1>(
          ah, al, 0, K / 8,
          [&](int row, int c) { return Rl[(ri + row) * RS + c] * F[(row < 8 ? f0 : f1) + c]; },
          [&](int c, int) { return Kl[(cj + g) * RS + c]; });
      const int cc = cj + 2 * t4;
      if (f0 != K * F_ZERO)
        store2(&A[(ri + g) * AS + cc], ah[0][0] + al[0][0], ah[0][1] + al[0][1]);
      store2(&A[(ri + g + 8) * AS + cc], ah[0][2] + al[0][2], ah[0][3] + al[0][3]);
    }
    {
      const int p = (warp * L::BT) / NSC, nb = (warp * L::BT) % NSC;
      float bh_[L::BT][4], bl_[L::BT][4];
      zero(bh_, bl_);
      mma_steps<EX, EX, L::BT>(
          bh_, bl_, 0, K / 8, [&](int row, int c) { return to_f(raw_dy[(16 * p + row) * RT + c]); },
          [&](int c, int n) { return to_f(raw_v[(8 * (nb + n) + g) * RT + c]); });
#pragma unroll
      for (int n = 0; n < L::BT; ++n) {
        const int cc = 8 * (nb + n) + 2 * t4;
        store2(&Bm[(16 * p + g) * AS + cc], bh_[n][0] + bl_[n][0], bh_[n][1] + bl_[n][1]);
        store2(&Bm[(16 * p + g + 8) * AS + cc], bh_[n][2] + bl_[n][2], bh_[n][3] + bl_[n][3]);
      }
    }
    __syncthreads();  // A and B are whole

    // ---- 3. warp (p, n0): rows 16 p .. + 15 (sub-chunks a0 = 2 p, a1 =
    // 2 p + 1) and n8 tiles n0, n0 + 1 of dv, and, after P and the carry, of
    // dr's and dk's sums before their row factors (Y = Ss dy and X = dSe v,
    // at each row's sub-chunk)
    const int p = warp / L::WPR, n0 = NN * (warp % L::WPR);
    const int a0 = 2 * p, a1 = a0 + 1;
    const int ra = 16 * p;
    {  // dv = (Kl F_SUF) dSe + A^T dY over l >= the tile's rows
      float ch_[NN][4], cl_[NN][4];
      zero(ch_, cl_);
      mma_steps<false, false, NN>(
          ch_, cl_, 0, K / 8,
          [&](int row, int c) {
            return Kl[(ra + row) * RS + c] * F[(F_SUF + (ra + row) / SC) * K + c];
          },
          [&](int c, int n) { return dS[c * RS + 8 * (n0 + n) + g]; });
      mma_steps<false, EX, NN>(
          ch_, cl_, a0, NSC, [&](int row, int l) { return A[l * AS + ra + row]; },
          [&](int l, int n) { return to_f(raw_dy[l * RT + 8 * (n0 + n) + g]); });
      T* dvb = dv + base + (size_t)t0 * step;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int kk = 8 * (n0 + n) + 2 * t4;
        if (ra + g < nt)
          store2(dvb + (size_t)(ra + g) * step + kk, ch_[n][0] + cl_[n][0], ch_[n][1] + cl_[n][1]);
        if (ra + g + 8 < nt)
          store2(dvb + (size_t)(ra + g + 8) * step + kk, ch_[n][2] + cl_[n][2],
                 ch_[n][3] + cl_[n][3]);
      }
    }
    // the warp's K x V tiles (rows m0, m1 of the state, columns nc ..): P_a =
    // sum_v Ss_a dSe_a per sub-chunk a, the state at a's start carried
    // forward (Ss_{a+1} = G_a Ss_a + Kl_a^T V_a) and the gradient at its end
    // back (dSe_{a-1} = G_a dSe_a + Rl_a^T dY_a, dSe_7 = dSe), meeting in the
    // middle: dSe_4..6 kept, the states carried from S0 to Ss_7 beside
    // dSe_4..7, then the gradient carried on to dSe_0 beside Ss_3..0, each
    // carried again from S0 rather than kept, for registers (20 products of
    // one k-step, each in its own zeroed pair); the warp's part of P over its
    // columns into Pp[column group][a][row].  Then the carry dS0 = F_TOT dSe
    // + (Rl F_PRE)^T dY, into dS once dSe's readers are done.
    const int mt = (warp * TPW) / L::NVT, nc = (warp * TPW) % L::NVT;
    const int m0 = 16 * mt + g, m1 = m0 + 8;
    {
      auto step = [&](int a, const float* X, const T* Y, float (&s)[TPW][4]) {
        float dh[TPW][4], dl[TPW][4];
        zero(dh, dl);
        mma_steps<false, EX, TPW>(
            dh, dl, a, a + 1, [&](int row, int j) { return X[j * RS + 16 * mt + row]; },
            [&](int j, int n) { return to_f(Y[j * RT + 8 * (nc + n) + g]); });
        const float g0 = G[a * K + m0], g1 = G[a * K + m1];
#pragma unroll
        for (int q = 0; q < TPW; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[q][e] = fmaf(e < 2 ? g0 : g1, s[q][e], dh[q][e] + dl[q][e]);
      };
      auto put_p = [&](int a, const float (&x)[TPW][4], const float (&y)[TPW][4]) {
        float pp0 = 0.f, pp1 = 0.f;
#pragma unroll
        for (int q = 0; q < TPW; ++q) {
          pp0 = fmaf(x[q][0], y[q][0], fmaf(x[q][1], y[q][1], pp0));
          pp1 = fmaf(x[q][2], y[q][2], fmaf(x[q][3], y[q][3], pp1));
        }
        pp0 += __shfl_xor_sync(FULL, pp0, 1);
        pp0 += __shfl_xor_sync(FULL, pp0, 2);
        pp1 += __shfl_xor_sync(FULL, pp1, 1);
        pp1 += __shfl_xor_sync(FULL, pp1, 2);
        if (t4 == 0) {
          Pp[((nc / TPW) * NSC + a) * K + m0] = pp0;
          Pp[((nc / TPW) * NSC + a) * K + m1] = pp1;
        }
      };
      // Ss_0 is S0 and dSe_7 is dSe, read from shared memory
      auto tile = [&](const float* X, float (&s)[TPW][4]) {
#pragma unroll
        for (int q = 0; q < TPW; ++q) {
          const int cc = 8 * (nc + q) + 2 * t4;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[q][e] = X[m0 * RS + cc + e];
            s[q][2 + e] = X[m1 * RS + cc + e];
          }
        }
      };
      constexpr int H = NSC / 2;
      float ds[H - 1][TPW][4], cur[TPW][4];
      tile(dS, cur);
#pragma unroll
      for (int a = NSC - 1; a > H; --a) {  // dSe_6 .. dSe_4 kept
        step(a, Rl, raw_dy, cur);
#pragma unroll
        for (int q = 0; q < TPW; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[a - 1 - H][q][e] = cur[q][e];
      }
      tile(S0, cur);
#pragma unroll
      for (int a = 0; a < NSC; ++a) {  // Ss_1 .. Ss_7; from Ss_4 beside dSe_4 .. dSe_7
        if (a > 0) step(a - 1, Kl, raw_v, cur);
        if (a >= H) {
          float de[TPW][4];
          if (a + 1 < NSC) {
#pragma unroll
            for (int q = 0; q < TPW; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) de[q][e] = ds[a - H][q][e];
          } else {
            tile(dS, de);
          }
          put_p(a, cur, de);
        }
      }
#pragma unroll
      for (int q = 0; q < TPW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[q][e] = ds[0][q][e];
#pragma unroll
      for (int a = H - 1; a >= 0; --a) {  // dSe_3 .. dSe_0 beside Ss_3 .. Ss_0, again
        step(a + 1, Rl, raw_dy, cur);
        float sa[TPW][4];
        tile(S0, sa);
#pragma unroll
        for (int b = 0; b < a; ++b) step(b, Kl, raw_v, sa);
        put_p(a, sa, cur);
      }
    }
    float cr[TPW][4];
    state_product<T, K>(Rl, F, F_PRE, raw_dy, cr);
    {
      const float tot0 = F[F_TOT * K + m0], tot1 = F[F_TOT * K + m1];
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const int cc = 8 * (nc + q) + 2 * t4;
        cr[q][0] = fmaf(tot0, dS[m0 * RS + cc], cr[q][0]);
        cr[q][1] = fmaf(tot0, dS[m0 * RS + cc + 1], cr[q][1]);
        cr[q][2] = fmaf(tot1, dS[m1 * RS + cc], cr[q][2]);
        cr[q][3] = fmaf(tot1, dS[m1 * RS + cc + 1], cr[q][3]);
      }
    }
    float yv[NN][4], xv[NN][4];
    {  // Y: acc = dY (S0 F_PRE(a0))^T + sum_{b<a0} B (Kl_b between(b, a0));
       // a1's rows G_{a0} acc + B[a1, a0] Kl_{a0}
      float ch_[NN][4], cl_[NN][4], eh[NN][4], el[NN][4];
      zero(ch_, cl_);
      zero(eh, el);
      mma_steps<EX, false, NN>(
          ch_, cl_, 0, K / 8, [&](int row, int c) { return to_f(raw_dy[(ra + row) * RT + c]); },
          [&](int c, int n) {
            const int kk = 8 * (n0 + n) + g;
            return S0[kk * RS + c] * F[(F_PRE + a0) * K + kk];
          });
      mma_steps<false, false, NN>(
          ch_, cl_, 0, a0, [&](int row, int j) { return Bm[(ra + row) * AS + j]; },
          [&](int j, int n) {
            const int kk = 8 * (n0 + n) + g;
            return Kl[j * RS + kk] * F[between(j / SC, a0) * K + kk];
          });
      mma_steps<false, false, NN>(
          eh, el, a0, a1, [&](int row, int j) { return row < 8 ? 0.f : Bm[(ra + row) * AS + j]; },
          [&](int j, int n) { return Kl[j * RS + 8 * (n0 + n) + g]; });
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          yv[n][e] = ch_[n][e] + cl_[n][e];
          if (e >= 2)
            yv[n][e] = fmaf(G[a0 * K + 8 * (n0 + n) + 2 * t4 + e - 2], yv[n][e],
                            eh[n][e] + el[n][e]);
        }
    }
    {  // X: acc = V (dSe F_SUF(a1))^T + sum_{c>a1} B^T (Rl_c between(a1, c));
       // a0's rows G_{a1} acc + B[a1, a0]^T Rl_{a1}
      float ch_[NN][4], cl_[NN][4], eh[NN][4], el[NN][4];
      zero(ch_, cl_);
      zero(eh, el);
      mma_steps<EX, false, NN>(
          ch_, cl_, 0, K / 8, [&](int row, int c) { return to_f(raw_v[(ra + row) * RT + c]); },
          [&](int c, int n) {
            const int kk = 8 * (n0 + n) + g;
            return dS[kk * RS + c] * F[(F_SUF + a1) * K + kk];
          });
      mma_steps<false, false, NN>(
          ch_, cl_, a1 + 1, NSC, [&](int row, int l) { return Bm[l * AS + ra + row]; },
          [&](int l, int n) {
            const int kk = 8 * (n0 + n) + g;
            return Rl[l * RS + kk] * F[between(a1, l / SC) * K + kk];
          });
      mma_steps<false, false, NN>(
          eh, el, a1, a1 + 1, [&](int row, int l) { return row < 8 ? Bm[l * AS + ra + row] : 0.f; },
          [&](int l, int n) { return Rl[l * RS + 8 * (n0 + n) + g]; });
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xv[n][e] = ch_[n][e] + cl_[n][e];
          if (e < 2)
            xv[n][e] = fmaf(G[a1 * K + 8 * (n0 + n) + 2 * t4 + e], xv[n][e], eh[n][e] + el[n][e]);
        }
    }
    __syncthreads();  // every read of Rl, Kl, S0, dSe and P's parts is done
#pragma unroll
    for (int q = 0; q < TPW; ++q) {  // dS <- the carry
      const int cc = 8 * (nc + q) + 2 * t4;
      store2(&dS[m0 * RS + cc], cr[q][0], cr[q][1]);
      store2(&dS[m1 * RS + cc], cr[q][2], cr[q][3]);
    }
    if (ch > 0) {  // the previous chunk's start, under this chunk's epilogue
      load_state(ch == 1 ? s0 + (size_t)bh * K * K
                         : ckpt + ((size_t)bh * (nch - 1) + ch - 2) * K * K);
      cp_async_commit();
    }

    // ---- 4. Y and X into Rl's and Kl's space; then thread (a, c), one
    // channel of one sub-chunk, its 8 rows of dr, dk and dw: the row factors
    // Wl, Wr and the pairs inside the sub-chunk, each decay multiplied up
    // step by step, and
    //   dw_i = Wl Wr P_a + Wr sum_{j<i} k_j d(j,i) X_j + Wl sum_{l>i} r_l d(i,l) Y_l
    //          + sum_{j<i<l} k_j r_l d(j,i) d(i,l) B_lj     (j, l in the sub-chunk)
    float* Yv = Rl;
    float* Xv = Kl;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int kk = 8 * (n0 + n) + 2 * t4;
      store2(&Yv[(ra + g) * RS + kk], yv[n][0], yv[n][1]);
      store2(&Yv[(ra + g + 8) * RS + kk], yv[n][2], yv[n][3]);
      store2(&Xv[(ra + g) * RS + kk], xv[n][0], xv[n][1]);
      store2(&Xv[(ra + g + 8) * RS + kk], xv[n][2], xv[n][3]);
    }
    __syncthreads();
    static_assert(NT % K == 0 && NSC * K % NT == 0, "every item's channel is tid % K");
#pragma unroll
    for (int x = 0; x < NSC * K / NT; ++x) {  // the items side by side
      const int it = tid + x * NT, a = it / K, c = it % K, st = a * SC;
      float kx[SC], rx[SC], wx[SC];
#pragma unroll
      for (int y = 0; y < SC; ++y) {
        kx[y] = to_f(raw_k[(st + y) * RT + c]);
        rx[y] = to_f(raw_r[(st + y) * RT + c]);
        wx[y] = to_f(raw_w[(st + y) * RT + c]);
      }
      float pa = 0.f;
#pragma unroll
      for (int cg = 0; cg < L::NVT / TPW; ++cg) pa += Pp[(cg * NSC + a) * K + c];
      const float* Bs = Bm + st * AS + st;  // the sub-chunk's block of B
      T* drb = dr + base + (size_t)(t0 + st) * step + c;
      T* dkb = dk + base + (size_t)(t0 + st) * step + c;
      T* dwb = dw + base + (size_t)(t0 + st) * step + c;
#pragma unroll
      for (int y = 0; y < SC; ++y) {
        float kd[SC], rd = 1.f, in_r = 0.f, dwx = 0.f;
#pragma unroll
        for (int j = y - 1; j >= 0; --j) {
          if (j < y - 1) rd *= wx[j + 1];
          kd[j] = kx[j] * rd;
          in_r = fmaf(Bs[y * AS + j], kd[j], in_r);
          dwx = fmaf(Xv[(st + j) * RS + c], kd[j], dwx);
        }
        const float wl = y > 0 ? rd * wx[0] : 1.f;
        float rd2 = 1.f, in_k = 0.f, dwy = 0.f, delta = 0.f;
#pragma unroll
        for (int l = y + 1; l < SC; ++l) {
          if (l > y + 1) rd2 *= wx[l - 1];
          const float rdl = rx[l] * rd2;
          in_k = fmaf(Bs[l * AS + y], rdl, in_k);
          dwy = fmaf(Yv[(st + l) * RS + c], rdl, dwy);
          float q = 0.f;
#pragma unroll
          for (int j = 0; j < y; ++j) q = fmaf(kd[j], Bs[l * AS + j], q);
          delta = fmaf(rdl, q, delta);
        }
        const float wr = y < SC - 1 ? rd2 * wx[SC - 1] : 1.f;
        const float bii = Bs[y * AS + y];
        du_acc = fmaf(kx[y] * rx[y], bii, du_acc);
        if (st + y < nt) {
          const size_t o = (size_t)y * step;
          drb[o] = from_f<T>(fmaf(wl, Yv[(st + y) * RS + c], in_r + su[c] * kx[y] * bii));
          dkb[o] = from_f<T>(fmaf(wr, Xv[(st + y) * RS + c], in_k + su[c] * rx[y] * bii));
          dwb[o] = from_f<T>(fmaf(wl * wr, pa, fmaf(wr, dwx, fmaf(wl, dwy, delta))));
        }
      }
    }
    __syncthreads();  // every read of this chunk's inputs is done
    if (!L::DB && ch > 0) fetch(seq + 1, 0);
    buf ^= L::DB;
  }
  __syncthreads();

  for (int i = tid; i < K * K; i += NT) dstate[(size_t)bh * K * K + i] = dS[(i / K) * RS + i % K];
  Pp[tid] = du_acc;  // du: the parts of channel c in thread order
  __syncthreads();
  if (tid < K) {
    float acc = 0.f;
    for (int j = 0; j < NT / K; ++j) acc += Pp[j * K + tid];
    du_part[(size_t)bh * K + tid] = acc;
  }
}

// du = the sum of its B parts, in batch order
template <typename T>
__global__ void wkv6_bwd_combine(const float* __restrict__ du_part, T* __restrict__ du, int B,
                                 int HK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HK) return;
  float acc = 0.f;
  for (int bb = 0; bb < B; ++bb) acc += du_part[(size_t)bb * HK + i];
  du[i] = from_f<T>(acc);
}

template <typename T, int K>
cudaError_t prepare() {
  return cudaFuncSetAttribute(wkv6_bwd_main<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Cfg<T, K>::bytes);
}

template <typename T, int K>
int launch_k(const void* r, const void* k, const void* v, const void* w, const void* u,
             const float* s0, const void* dy, const float* ds_out, void* dr, void* dk,
             void* dv, void* dw, void* du, float* dstate, float* ckpt, float* du_part, int B,
             int T_len, int H, cudaStream_t stream) {
  cudaError_t err = prepare<T, K>();
  if (err != cudaSuccess) return err;
  wkv6_bwd_main<T, K><<<B * H, Cfg<T, K>::NT, Cfg<T, K>::bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), s0, static_cast<const T*>(dy),
      ds_out, static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), du_part, dstate, ckpt, T_len, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_combine<T><<<(H * K + 255) / 256, 256, 0, stream>>>(du_part, static_cast<T*>(du),
                                                              B, H * K);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const float* s0, const void* dy, const float* ds_out, void* dr, void* dk, void* dv,
           void* dw, void* du, float* dstate, float* ckpt, float* du_part, int B, int T_len,
           int H, int K, cudaStream_t stream) {
  if (K == 64)
    return launch_k<T, 64>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du, dstate, ckpt,
                           du_part, B, T_len, H, stream);
  if (K == 32)
    return launch_k<T, 32>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du, dstate, ckpt,
                           du_part, B, T_len, H, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int K>
int occupancy_k(int* out) {
  cudaError_t err = prepare<T, K>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes at;
  err = cudaFuncGetAttributes(&at, wkv6_bwd_main<T, K>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_bwd_main<T, K>,
                                                      Cfg<T, K>::NT, Cfg<T, K>::bytes);
  out[0] = (int)Cfg<T, K>::bytes;
  out[1] = Cfg<T, K>::NT;
  out[2] = at.numRegs;
  out[3] = blocks;
  return err;
}

}  // namespace

// C entry point, bound with ctypes.  r, k, v, w, dy: [B,T,H,K] contiguous,
// 16-byte aligned, float32 (dtype 0) or bfloat16 (dtype 1); u: [H,K] of the
// same type; s0: [B,H,K,K] float32; ds_out: the final state's gradient,
// [B,H,K,K] float32, or null for zero.  Out: dr, dk, dv, dw [B,T,H,K] and du
// [H,K] in the input type, dstate [B,H,K,K] float32.  Workspaces, float32:
// ckpt B H (ceil(T / 64) - 1) K K (the chunks' starting states), du_part
// B H K.  K is 32 or 64, T >= 1.  Returns a cudaError_t; 0 on success.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const float* s0, const void* dy,
                              const float* ds_out, void* dr, void* dk, void* dv, void* dw,
                              void* du, float* dstate, float* ckpt, float* du_part, int B,
                              int T_len, int H, int K, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du, dstate, ckpt,
                         du_part, B, T_len, H, K, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, dy, ds_out, dr, dk, dv, dw, du, dstate,
                                 ckpt, du_part, B, T_len, H, K, st);
  return cudaErrorInvalidValue;
}

// The main kernel's launch for (dtype, K): out[0] its dynamic shared memory
// in bytes, out[1] its threads a block, out[2] its registers a thread,
// out[3] the blocks that fit on one SM.  Returns a cudaError_t.
extern "C" int repro_wkv6_bwd_occupancy(int dtype, int K, int* out) {
  if (dtype == 0 && K == 64) return occupancy_k<float, 64>(out);
  if (dtype == 0 && K == 32) return occupancy_k<float, 32>(out);
  if (dtype == 1 && K == 64) return occupancy_k<__nv_bfloat16, 64>(out);
  if (dtype == 1 && K == 32) return occupancy_k<__nv_bfloat16, 32>(out);
  return cudaErrorInvalidValue;
}
