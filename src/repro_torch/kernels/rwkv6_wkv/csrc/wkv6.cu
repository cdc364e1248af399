// WKV6 recurrence (RWKV6 "Finch" time mixing) for Hopper (sm_90a), float32 or
// bfloat16 inputs, float32 arithmetic and state, in the chunked form whose
// matrix products run on the tensor cores.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` behind `wkv6_bthk`
// (src/repro/kernels/rwkv6_wkv/kernel.py).  Per batch row b and head h, with
// r, k, v, w of shape [B,T,H,K], bonus u [H,K] and the state S [B,H,K,K]
// (row k, column v), the plain loop is
//
//     y_t[v] = sum_k r_t[k] S[k][v] + v_t[v] * sum_k u[k] k_t[k] r_t[k]
//     S[k][v] <- w_t[k] S[k][v] + k_t[k] v_t[v]
//
// y is written in the input type, the final state in float32.
//
// The chunked form.  Time is cut into chunks of C = 64 steps and each chunk
// into eight sub-chunks of SC = 8.  With the decay of a channel from step
// j + 1 up to step i - 1 written d(j, i) = w_{j+1} ... w_{i-1} (1 if j + 1 = i),
// and S0 the state at the chunk's start, within a chunk
//
//     y_i = sum_k r_i d(-1, i) S0 + sum_{j<i} A_ij v_j,   A_ij = sum_k r_i k_j d(j, i),
//           A_ii = sum_k u r_i k_i
//     S_C = d(-1, C) S0 + sum_j (k_j d(j, C)) v_j^T
//
// so a chunk is four matrix products and a small triangular part, and only
// the state carries from chunk to chunk: T/C dependent steps, not T.
//
// Numerics.  Every decay is a product of w's taken in float32, as the plain
// loop takes them, never a quotient or the exponential of a log: a factor is
// at most 1, an exact w = 0 (the model rounds exp(-exp(x)) to bfloat16, so
// 0 and 1 occur) zeroes what it should, and no floor on log w is needed.
// The factoring keeps every factor <= 1: a pair (i, j) in sub-chunks a > b
// splits into r_i d(s_a - 1, i) (the decay within a, from its start s_a),
// G_{b+1} ... G_{a-1} (the whole sub-chunks between, G_c a sub-chunk's
// product) and k_j d(j, e_b) (the decay to the end e_b of b).  Split at the
// chunk's start instead, the k side is k_j / d(-1, j + 1), which overflows,
// or is 0/0, once a decay near 0 comes before j (the model's decays reach
// e^-54.6 and 0).  A pair within one sub-chunk has no such split: its 28
// pairs a sub-chunk are summed on the CUDA cores, each with its decay
// multiplied up step by step.  The products run on the tensor cores as
// 3xTF32 (tests/test_torch_kernels.py emulates each choice): every float32
// operand x is split into hi (x, of which the tensor core reads the top 10
// mantissa bits) and lo = x - hi (truncated in its turn), and a product is
// lo hi' + hi lo' + hi hi'; one TF32 product misses the float32 check ~46x.
// v in bfloat16 is exact in TF32, so its products take two terms.  Each
// product is summed in two zeroed accumulators, the hi terms and the lo
// terms (at most 16 sums each), and added in float32 after.
//
// What bounds it on an H100: per (b, h) and chunk, C K V multiply-adds for y's
// state term and as many for the state update, ~C^2 V / 2 for A V and ~C^2 K / 2
// for A between sub-chunks, on the tensor cores at three TF32 products each
// (two where v is exact); 28 K multiply-adds and as many multiplies per
// sub-chunk for its pairs, and the decays within sub-chunks, on the CUDA
// cores; against 5 K values read or written per step.  At rwkv6-7b's heads
// (K 64) in bfloat16 that is ~86 tensor-core flops a byte, under the ~148 at
// which TF32 work leaves memory behind: the bytes bound the work
// (chip_smoke.wkv6_operations counts both).  What holds the kernel back is
// latency: a chunk's work is a chain of phases separated by barriers, with
// one block of eight warps an SM (launch/wkv6_phases.py times each phase).
//
// Design.  One block of eight warps per (b, h, V-tile of 32 columns): 2 B H
// blocks at K 64, B H at K 32.  The block walks the chunks in order; the
// state tile [K, 32] stays in shared memory.  Per chunk:
//   1. the chunk's raw r, k, w and the block's v columns arrived by cp.async
//      under the previous chunk's products.  Warps 0-3: Rl_i = r_i d(s_a - 1, i)
//      and Kl_j = k_j d(j, e_b), one thread a channel walking the 64 steps
//      forward or backward (w past a ragged end taken as 1), the sub-chunk
//      products G_a and from them the table F of cross-sub-chunk factors.
//      Warps 4-7: v as float32, and the diagonal blocks of A: a thread holds
//      8 channels of rows q and 7 - q of a sub-chunk (7 pairs, q one per
//      warp) and walks j down from i, multiplying the decay up; the 8 lanes
//      of a row sum their channels by halving exchanges (reduce8); the bonus
//      goes on A's diagonal;
//   2. the next chunk's cp.async is issued;
//   3. warps 2 p, 2 p + 1: y's state term for rows 16 p .. 16 p + 15, half
//      the V-tile each, (Rl F_pre) S0, by mma.sync m16n8k8 (TF32); every
//      warp: two of the sixteen 16 x 8 tiles of A between sub-chunks,
//      (Rl F_between) Kl^T, the between-factor on the row's side so that one
//      B serves the tile's two sub-chunks;
//   4. the same warps: A V for their rows, y written out; every warp: the
//      state update S = F_tot S + (Kl F_suf)^T V for its tiles of S.
// Three barriers a chunk.  A block's arithmetic depends on its own (b, h)
// only: no atomics, nothing split by the batch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int C = 64;          // time steps per chunk
constexpr int SC = 8;          // time steps per sub-chunk
constexpr int NSC = C / SC;    // sub-chunks per chunk
constexpr int VT = 32;         // value columns per block
constexpr int NW = 8;          // warps per block: two per 16 rows (two sub-chunks)
constexpr int NT = 32 * NW;
constexpr int NVT = VT / 8;    // n8 tiles across the V-tile
constexpr int AS = C + 4;      // row stride of A (floats): fragment reads hit 32 banks
constexpr int VS = VT + 8;     // row stride of v and S
static_assert(C == NW * SC, "two warps per two sub-chunks");

// F's rows: the decay of whole sub-chunks, per channel
constexpr int F_PRE = 0;          // F_PRE + a: G_0 ... G_{a-1} (sub-chunks before a)
constexpr int F_SUF = NSC;        // F_SUF + b: G_{b+1} ... G_{NSC-1} (after b)
constexpr int F_TOT = 2 * NSC;    // the whole chunk
constexpr int F_BETWEEN = F_TOT + 1;  // + a (a - 1) / 2 + b for b < a: G_{b+1} ... G_{a-1}
constexpr int F_ONE = F_BETWEEN + NSC * (NSC - 1) / 2;  // all 1
constexpr int F_ZERO = F_ONE + 1;                        // all 0
constexpr int F_ROWS = F_ZERO + 1;

template <typename T, int K>
struct Smem {
  static constexpr int RS = K + 4;  // row stride of Rl and Kl (floats)
  static constexpr size_t raw_rkw = (size_t)C * K * sizeof(T);
  static constexpr size_t raw_v = (size_t)C * VT * sizeof(T);
  static constexpr size_t r = 0, k = r + raw_rkw, w = k + raw_rkw, v = w + raw_rkw;
  static constexpr size_t rl = v + raw_v;
  static constexpr size_t kl = rl + (size_t)C * RS * 4;
  static constexpr size_t a = kl + (size_t)C * RS * 4;
  static constexpr size_t vf = a + (size_t)C * AS * 4;
  static constexpr size_t s = vf + (size_t)C * VS * 4;
  static constexpr size_t f = s + (size_t)K * VS * 4;
  static constexpr size_t g = f + (size_t)F_ROWS * K * 4;  // G_a per channel
  static constexpr size_t bytes = g + (size_t)NSC * K * 4;
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

// n consecutive values from 16-byte aligned shared memory, as float32
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

// The 3xTF32 product with B's fragment given as float32: dh += a.hi b.hi and
// dl += a.lo b.hi + a.hi b.lo, the small terms in their own accumulator, so
// the two chains of dependent mma run side by side.  B_EXACT: B's values are
// exact in TF32 (bfloat16 v), and a.hi b.lo is 0.
template <bool B_EXACT>
__device__ __forceinline__ void mma3(float (&dh)[4], float (&dl)[4], const Frag& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(dl, a.lo, bh0, bh1);
  if (!B_EXACT) mma(dl, a.hi, bl0, bl1);
  mma(dh, a.hi, bh0, bh1);
}

// Sums over the 8 lanes of a group (lane bits 0-2 = kg) of 8 values each:
// lane kg returns the sum of everyone's v[kg], after 7 shuffles (three
// halving exchanges) where 8 separate sums take 24.
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

// One channel's walk over a chunk: FWD, dst_i = x_i w_s ... w_{i-1} from its
// sub-chunk's start s (Rl from r), and G[a][kk] = G_a, each sub-chunk's
// product; else dst_i = x_i w_{i+1} ... w_{e-1} to its end e (Kl from k).  w
// past the chunk's nt valid steps counts as 1.  Two sub-chunks' values come
// into registers before their stores, which the compiler could not move later
// loads past.  The loop over the pairs stays rolled: unrolled, the code grew
// and a served 512-token prompt took a tenth longer on an H100.
template <bool FWD, int K, typename T>
__device__ __forceinline__ void walk(const T* x, const T* w, float* dst, int kk, int nt,
                                     float* G) {
  constexpr int RS = K + 4;
#pragma unroll 1
  for (int a0 = 0; a0 < NSC; a0 += 2) {
    float xv[2 * SC], wv[2 * SC];
#pragma unroll
    for (int i = 0; i < 2 * SC; ++i) {
      const int t = a0 * SC + i;
      xv[i] = to_f(x[t * K + kk]);
      wv[i] = t < nt ? to_f(w[t * K + kk]) : 1.f;
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float c = 1.f;
#pragma unroll
      for (int y = 0; y < SC; ++y) {
        const int i = h2 * SC + (FWD ? y : SC - 1 - y);
        dst[(a0 * SC + i) * RS + kk] = xv[i] * c;
        c *= wv[i];
      }
      if (FWD) G[(a0 + h2) * K + kk] = c;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(NT, 1)
wkv6_chunked(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const T* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ y, float* __restrict__ s_out, int T_len, int H) {
  using L = Smem<T, K>;
  constexpr int RS = L::RS;
  constexpr int KG = K / 8;                  // channels per thread in the pair pass
  constexpr int EPC = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr bool V_EXACT = sizeof(T) == 2;   // bfloat16 v is exact in TF32
  constexpr int NH = NVT / 2;                // n8 tiles of y a warp takes
  constexpr int TPW = (K / 16) * NVT / NW;   // state-update tiles per warp
  static_assert(TPW >= 1 && (K / 16) * NVT % NW == 0, "state tiles spread over the warps");

  extern __shared__ __align__(16) uint8_t smem[];
  T* raw_r = reinterpret_cast<T*>(smem + L::r);
  T* raw_k = reinterpret_cast<T*>(smem + L::k);
  T* raw_w = reinterpret_cast<T*>(smem + L::w);
  T* raw_v = reinterpret_cast<T*>(smem + L::v);
  float* Rl = reinterpret_cast<float*>(smem + L::rl);
  float* Kl = reinterpret_cast<float*>(smem + L::kl);
  float* A = reinterpret_cast<float*>(smem + L::a);
  float* Vf = reinterpret_cast<float*>(smem + L::vf);
  float* S = reinterpret_cast<float*>(smem + L::s);
  float* F = reinterpret_cast<float*>(smem + L::f);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  constexpr int NVG = K / VT;                // V-tiles per head
  const int bh = blockIdx.x / NVG;
  const int v0 = (blockIdx.x % NVG) * VT;
  const int b = bh / H, h = bh - b * H;

  const size_t step = (size_t)H * K;          // elements between time steps
  const size_t base = ((size_t)b * T_len * H + h) * K;
  const T *rb = r + base, *kb = k + base, *wb = w + base, *vb = v + base + v0;

  // the initial state's tile
  const float* s0p = s0 + (size_t)bh * K * K + v0;
  for (int i = tid; i < K * VT / 4; i += NT) {
    const int row = i / (VT / 4), c = (i % (VT / 4)) * 4;
    *reinterpret_cast<float4*>(&S[row * VS + c]) =
        *reinterpret_cast<const float4*>(&s0p[(size_t)row * K + c]);
  }
  // the pair pass (the block's second half): thread (pr, kg) owns channels
  // [kg KG, kg KG + KG) of two rows of sub-chunk 4 half + pr % 4, q = pr / 4
  // and 7 - q: 7 pairs; q is one per warp, so no branch diverges
  const int pt = tid - NT / 2;
  const int pr = pt / 8, kg = pt % 8;
  float uu[KG];
#pragma unroll
  for (int i = 0; i < KG; ++i) uu[i] = pt >= 0 ? to_f(u[(size_t)h * K + kg * KG + i]) : 0.f;

  auto load_chunk = [&](int t0) {
    const int nt = min(C, T_len - t0);
    constexpr int PR = K / EPC, PV = VT / EPC;
    for (int i = tid; i < C * PR; i += NT) {
      const int tt = i / PR, off = (i - tt * PR) * EPC;
      const bool ok = tt < nt;
      const size_t gi = (size_t)(ok ? t0 + tt : t0) * step + off;
      cp_async16(&raw_r[tt * K + off], rb + gi, ok);
      cp_async16(&raw_k[tt * K + off], kb + gi, ok);
      cp_async16(&raw_w[tt * K + off], wb + gi, ok);
    }
    for (int i = tid; i < C * PV; i += NT) {
      const int tt = i / PV, off = (i - tt * PV) * EPC;
      const bool ok = tt < nt;
      cp_async16(&raw_v[tt * VT + off], vb + (size_t)(ok ? t0 + tt : t0) * step + off, ok);
    }
    cp_async_commit();
  };

  const int nch = (T_len + C - 1) / C;
  load_chunk(0);
  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * C;
    const int nt = min(C, T_len - t0);
    cp_async_wait_all();
    __syncthreads();  // the chunk is in; the previous chunk's readers are done

    // ---- 1. the first half of the block: the decays within sub-chunks and
    // the table F; the second half: v as float32 and A's diagonal blocks
    if (pt < 0) {
      if (tid < 2 * K) {
        const int kk = tid % K;
        float* G = reinterpret_cast<float*>(smem + L::g);
        if (tid < K) walk<true, K>(raw_r, raw_w, Rl, kk, nt, G);
        else walk<false, K>(raw_k, raw_w, Kl, kk, nt, G);
        if (tid < K) {
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
              F[(F_BETWEEN + a * (a - 1) / 2 + bs) * K + kk] = c;
              c *= gs[a];
            }
          }
        }
      }
    } else {
      {
        constexpr int NV = C * VT / 8 / (NT / 2);  // 8-value pieces of v a thread converts
        float xv[NV][8];
#pragma unroll
        for (int x = 0; x < NV; ++x) load_n<8>(&raw_v[(pt + x * NT / 2) * 8], xv[x]);
#pragma unroll
        for (int x = 0; x < NV; ++x) {
          const int e = (pt + x * NT / 2) * 8;
          float* d = &Vf[(e / VT) * VS + e % VT];
          *reinterpret_cast<float4*>(d) = make_float4(xv[x][0], xv[x][1], xv[x][2], xv[x][3]);
          *reinterpret_cast<float4*>(d + 4) = make_float4(xv[x][4], xv[x][5], xv[x][6], xv[x][7]);
        }
      }
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int a = 4 * half + pr % 4, q = pr / 4;
        const int i1 = a * SC + q, i2 = a * SC + SC - 1 - q;
        float r1[KG], r2[KG], rd[KG], kx[KG], part[8], b2 = 0.f;
        load_n<KG>(&raw_r[i1 * K + kg * KG], r1);
        load_n<KG>(&raw_k[i1 * K + kg * KG], kx);
        part[7] = 0.f;
#pragma unroll
        for (int x = 0; x < KG; ++x) part[7] = fmaf(uu[x] * r1[x], kx[x], part[7]);
        load_n<KG>(&raw_r[i2 * K + kg * KG], r2);
        load_n<KG>(&raw_k[i2 * K + kg * KG], kx);
#pragma unroll
        for (int x = 0; x < KG; ++x) b2 = fmaf(uu[x] * r2[x], kx[x], b2);
        // row i1 takes the first q pairs, row i2 the other SC - 1 - q: for
        // j = i - m, rd = r_i d(j, i), multiplied up by w_{j+1} as j falls;
        // part[it] is this thread's share of pair it
#pragma unroll
        for (int x = 0; x < KG; ++x) rd[x] = r1[x];
        int i = i1, m = 0;
#pragma unroll
        for (int it = 0; it < SC - 1; ++it) {
          if (it == q) {
            i = i2;
            m = 0;
#pragma unroll
            for (int x = 0; x < KG; ++x) rd[x] = r2[x];
          }
          const int j = i - ++m;
          if (m >= 2) {
            float wx[KG];
            load_n<KG>(&raw_w[(j + 1) * K + kg * KG], wx);
#pragma unroll
            for (int x = 0; x < KG; ++x) rd[x] *= wx[x];
          }
          load_n<KG>(&raw_k[j * K + kg * KG], kx);
          part[it] = 0.f;
#pragma unroll
          for (int x = 0; x < KG; ++x) part[it] = fmaf(rd[x], kx[x], part[it]);
        }
        // lane kg: pair kg, or row i1's bonus at kg = 7
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
        if (a % 2 == 0) {  // and in the next sub-chunk's columns, which A V reads too
          A[i1 * AS + j + SC] = 0.f;
          A[i2 * AS + j + SC] = 0.f;
        }
      }
    }
    __syncthreads();  // Rl, Kl, F, Vf and A's diagonal blocks are in; raw is free

    // ---- 2. the next chunk comes in under this chunk's products
    if (ch + 1 < nch) load_chunk(t0 + C);

    // ---- 3. warp w: y's state term for rows 16 (w / 2) .. + 15 (sub-chunks
    // w / 2 * 2 and + 1), n8 tiles NH (w % 2) ..; two tiles of A between
    // sub-chunks (products in pairs of accumulators, hi terms and lo terms:
    // see mma3).  Warps w and w + 4 share a scheduler: rows 16 (w / 2) and
    // 16 (w / 2 + 2), so the rows' unequal A V work is spread
    const int rw = warp / 2, n0y = NH * (warp % 2);
    const int ra = 16 * rw + g;  // this lane's rows ra and ra + 8
    float ysh[NH][4], ysl[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) ysh[n][x] = ysl[n][x] = 0.f;
#pragma unroll
    for (int s = 0; s < K / 8; ++s) {
      const int c0 = 8 * s + t4, c1 = c0 + 4;
      const float* pre = &F[(F_PRE + 2 * rw) * K];  // rows ra: pre[.]; ra + 8: pre[K + .]
      Frag fa;
      fa.set(Rl[ra * RS + c0] * pre[c0], Rl[(ra + 8) * RS + c0] * pre[K + c0],
             Rl[ra * RS + c1] * pre[c1], Rl[(ra + 8) * RS + c1] * pre[K + c1]);
#pragma unroll
      for (int n = 0; n < NH; ++n)
        mma3<false>(ysh[n], ysl[n], fa, S[c0 * VS + 8 * (n0y + n) + g],
                    S[c1 * VS + 8 * (n0y + n) + g]);
    }
    // tiles of A between sub-chunks: tile tau = p^2 + b takes rows 16 p ..
    // 16 p + 15 (sub-chunks 2 p and 2 p + 1) against the columns of sub-chunk
    // b <= 2 p; warp w takes tau = w and w + 8, side by side.  The decay
    // between b and a row's sub-chunk goes on the row's side (so that one B
    // serves both sub-chunks); rows of sub-chunk 2 p against b = 2 p are the
    // diagonal block, computed above: a factor 0 there, and no store.
    {
      constexpr int NTILE = 2;
      int ri[NTILE], cj[NTILE], f0[NTILE], f1[NTILE];
#pragma unroll
      for (int x = 0; x < NTILE; ++x) {
        const int tau = warp + NW * x;
        const int p = tau < 1 ? 0 : (tau < 4 ? 1 : (tau < 9 ? 2 : 3));
        const int bsub = tau - p * p;
        ri[x] = 16 * p + g;
        cj[x] = bsub * SC;
        // the two row-halves' factors, as offsets of rows of F
        const int a0 = 2 * p, a1 = 2 * p + 1;
        const int between0 = F_BETWEEN + a0 * (a0 - 1) / 2 + bsub;
        const int between1 = F_BETWEEN + a1 * (a1 - 1) / 2 + bsub;
        f0[x] = K * (bsub >= a0 ? F_ZERO : (bsub == a0 - 1 ? F_ONE : between0));
        f1[x] = K * (bsub == a1 - 1 ? F_ONE : between1);
      }
      float ah[NTILE][4], al[NTILE][4];
#pragma unroll
      for (int x = 0; x < NTILE; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) ah[x][e] = al[x][e] = 0.f;
#pragma unroll
      for (int s = 0; s < K / 8; ++s) {
        const int c0 = 8 * s + t4, c1 = c0 + 4;
#pragma unroll
        for (int x = 0; x < NTILE; ++x) {
          Frag fa;
          fa.set(Rl[ri[x] * RS + c0] * F[f0[x] + c0], Rl[(ri[x] + 8) * RS + c0] * F[f1[x] + c0],
                 Rl[ri[x] * RS + c1] * F[f0[x] + c1], Rl[(ri[x] + 8) * RS + c1] * F[f1[x] + c1]);
          mma3<false>(ah[x], al[x], fa, Kl[(cj[x] + g) * RS + c0], Kl[(cj[x] + g) * RS + c1]);
        }
      }
#pragma unroll
      for (int x = 0; x < NTILE; ++x) {
        const int cc = cj[x] + 2 * t4;
        if (f0[x] != K * F_ZERO) {
          A[ri[x] * AS + cc] = ah[x][0] + al[x][0];
          A[ri[x] * AS + cc + 1] = ah[x][1] + al[x][1];
        }
        A[(ri[x] + 8) * AS + cc] = ah[x][2] + al[x][2];
        A[(ri[x] + 8) * AS + cc + 1] = ah[x][3] + al[x][3];
      }
    }
    __syncthreads();  // A is whole; every read of this chunk's S0 is done

    // ---- 4. warp w: its rows' A V and y out; the state update
    float yvh[NH][4], yvl[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) yvh[n][x] = yvl[n][x] = 0.f;
#pragma unroll 2
    for (int s = 0; s < 2 * (rw + 1); ++s) {
      const int c0 = 8 * s + t4, c1 = c0 + 4;
      Frag fa;
      fa.set(A[ra * AS + c0], A[(ra + 8) * AS + c0], A[ra * AS + c1], A[(ra + 8) * AS + c1]);
#pragma unroll
      for (int n = 0; n < NH; ++n)
        mma3<V_EXACT>(yvh[n], yvl[n], fa, Vf[c0 * VS + 8 * (n0y + n) + g],
                      Vf[c1 * VS + 8 * (n0y + n) + g]);
    }
    T* yb = y + base + (size_t)t0 * step + v0;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      float o[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) o[x] = (ysh[n][x] + ysl[n][x]) + (yvh[n][x] + yvl[n][x]);
      const int cc = 8 * (n0y + n) + 2 * t4;
      if (ra < nt) store2(yb + (size_t)ra * step + cc, o[0], o[1]);
      if (ra + 8 < nt) store2(yb + (size_t)(ra + 8) * step + cc, o[2], o[3]);
    }

    float dsh[TPW][4], dsl[TPW][4];
#pragma unroll
    for (int q = 0; q < TPW; ++q)
#pragma unroll
      for (int x = 0; x < 4; ++x) dsh[q][x] = dsl[q][x] = 0.f;
    const int mt = (warp * TPW) / NVT, n0 = (warp * TPW) % NVT;
    const int m0 = 16 * mt + g, m1 = m0 + 8;  // this lane's rows of S
#pragma unroll
    for (int s = 0; s < C / 8; ++s) {
      const int tt0 = 8 * s + t4, tt1 = tt0 + 4;
      const float f0 = F[(F_SUF + s) * K + m0], f1 = F[(F_SUF + s) * K + m1];
      Frag fa;
      fa.set(Kl[tt0 * RS + m0] * f0, Kl[tt0 * RS + m1] * f1, Kl[tt1 * RS + m0] * f0,
             Kl[tt1 * RS + m1] * f1);
#pragma unroll
      for (int q = 0; q < TPW; ++q)
        mma3<V_EXACT>(dsh[q], dsl[q], fa, Vf[tt0 * VS + 8 * (n0 + q) + g],
                      Vf[tt1 * VS + 8 * (n0 + q) + g]);
    }
    const float tot0 = F[F_TOT * K + m0], tot1 = F[F_TOT * K + m1];
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      const int cc = 8 * (n0 + q) + 2 * t4;
      float* p0 = &S[m0 * VS + cc];
      float* p1 = &S[m1 * VS + cc];
      p0[0] = fmaf(tot0, p0[0], dsh[q][0] + dsl[q][0]);
      p0[1] = fmaf(tot0, p0[1], dsh[q][1] + dsl[q][1]);
      p1[0] = fmaf(tot1, p1[0], dsh[q][2] + dsl[q][2]);
      p1[1] = fmaf(tot1, p1[1], dsh[q][3] + dsl[q][3]);
    }
  }
  __syncthreads();

  float* sp = s_out + (size_t)bh * K * K + v0;
  for (int i = tid; i < K * VT / 4; i += NT) {
    const int row = i / (VT / 4), c = (i % (VT / 4)) * 4;
    *reinterpret_cast<float4*>(&sp[(size_t)row * K + c]) =
        *reinterpret_cast<const float4*>(&S[row * VS + c]);
  }
}

template <typename T, int K>
int launch_k(const void* r, const void* k, const void* v, const void* w, const void* u,
             const float* s0, void* y, float* s_out, int B, int T_len, int H,
             cudaStream_t stream) {
  constexpr size_t bytes = Smem<T, K>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunked<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  wkv6_chunked<T, K><<<B * H * (K / VT), NT, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), s0, static_cast<T*>(y), s_out,
      T_len, H);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const float* s0, void* y, float* s_out, int B, int T_len, int H, int K,
           cudaStream_t stream) {
  if (K == 64) return launch_k<T, 64>(r, k, v, w, u, s0, y, s_out, B, T_len, H, stream);
  if (K == 32) return launch_k<T, 32>(r, k, v, w, u, s0, y, s_out, B, T_len, H, stream);
  return cudaErrorInvalidValue;
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
