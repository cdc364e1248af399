// Flash-decode attention for Hopper (sm_90a): one query token per row
// against a long KV cache, with a float (float32 or bfloat16) cache or an
// int8 cache with float32 scales per (batch, kv head, position).
//
// Replaces the Pallas TPU kernels `_decode_kernel` and `_decode_kernel_int8`
// (src/repro/kernels/decode_attention/kernel.py:64 and :91) behind
// `decode_attention_grouped`, `decode_attention_grouped_cache`,
// `decode_attention_int8_grouped` and `decode_attention_int8_grouped_cache`.
// q is [B, KV, G, D]: the G query heads that share kv head `kv`.  Row b
// attends to the cache positions 0..cur_index[b], an int32 vector on the
// card, so one launch serves a lockstep batch (every entry equal) and a slot
// batch of continuous serving (one position per row) alike.  The scores and
// the softmax are float32; the scale is D^-0.5, applied to q in float32;
// the output has q's type.  int8: the k scale multiplies the scores and the
// v scale the probabilities before the PV product, as `_decode_kernel_int8`
// does, so no dequantized tile is ever formed.  The cache is read through
// its strides, so the serving layout [B, KV, S, D] and the kernel-native
// layout [B, S, KV, D] are both read in place.
//
// What bounds it on an H100: each cache byte is read once and feeds 2G
// multiply-adds (G = 2 for qwen3), far under the card's operations per
// byte, so the bytes of the valid cache positions bound it, at 3.35 TB/s.
// At a served decode step those are ~1 MB a row: a few microseconds, in
// which a kernel that waits on memory round trips one after another, or on
// a second launch, loses most of its time.  The design:
//
// - Split: one block per (batch row, kv head, group tile, chunk of CHUNK
//   positions); blocks past cur_index[b] exit at once.  CHUNK is fixed per
//   cache type and head size (32 KB of K rows: 128 positions of bfloat16 at
//   D 128, 256 of int8, 64 of float32), never by B, S or the batch, so a
//   row's summation order depends on its own cur_index only.  A block holds
//   one chunk of K and one of V, 64 KB, so three blocks share an SM and one
//   block's copies overlap another's arithmetic.
// - Bulk copies: one thread asks the TMA for the whole chunk, K on one
//   mbarrier and V on another (in the served layout a chunk's rows are
//   contiguous: one copy each; in [B, S, KV, D] one copy per row, spread
//   over the block's threads), marked evict-first in the L2.  Only the
//   n = min(CHUNK, cur + 1 - start) valid rows are copied; int8 scales come
//   with K where 16-byte aligned, else by plain loads.  One round trip per
//   block instead of ~16 loads waited on in turn, and the scores start as
//   soon as K has landed while V is still in flight.  q is requested before
//   the copies: a load issued behind them returns only after their bytes.
// - Scores from shared memory: L = 4 lanes (8 for 4-row group tiles) share
//   a cache row, each taking 16-byte pieces spread over the row in an order
//   rotated by the row, so a quarter warp's reads hit eight distinct bank
//   groups; q stays in registers in the same rotated order.  log2(L)
//   shuffles per (row, query head), 4 under the old kernel.  int8 is read
//   16 bytes per lane and turned into float32 by `__byte_perm` into
//   2^23 + (k + 128) and one subtraction: no conversion instruction, whose
//   pipe does 16 lanes a cycle (the old kernel's int8 was bound by it).
// - Softmax over all threads, the chunk's max found during the scores; P V
//   from the V tile: a warp takes D/4 lanes per row, 4 columns each, in
//   float32 registers; the warps' sums meet in shared memory.
// - Combine: a second kernel, launched with programmatic stream
//   serialization (PDL), so its launch overlaps the split's tail; it waits
//   at `griddepcontrol.wait`, and the split triggers it at its end.  A row's
//   partial outputs come in by bulk copies, a few stages in flight (the L2
//   still holds them: the cache went past it), and are combined in
//   ascending chunk order:
//   out = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int NT = 128;               // threads per split block: 4 warps
constexpr int NW = NT / 32;
constexpr int TILE_BYTES = 32768;     // one chunk of K rows (and one of V)
constexpr int CT = 128;               // threads per combine block
constexpr int COMBINE_STAGE_BYTES = 8192;  // partial outputs a combine stage copies
constexpr int CSTAGES = 4;            // combine stages in flight
constexpr float NEG_INF = -1e30f;

// Cache positions per split block, by cache type and head size only.
template <typename KT, int D>
__host__ __device__ constexpr int chunk_rows() {
  return TILE_BYTES / (D * static_cast<int>(sizeof(KT)));
}

template <typename KT, int GT, int D>
constexpr int split_smem_bytes() {
  constexpr int chunk = chunk_rows<KT, D>();
  constexpr bool int8 = std::is_same<KT, int8_t>::value;
  // K, V; scores [GT][chunk]; q [GT][D]; int8 scales; each warp's m and l
  // [2][NW][GT] and 8 bytes of padding; two mbarriers
  return 2 * TILE_BYTES + GT * chunk * 4 + GT * D * 4 + (int8 ? 2 * chunk * 4 : 0) +
         2 * NW * GT * 4 + 8 + 16;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------- TMA, mbarrier
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// Until the barrier's phase `parity` completes, i.e. its bytes have landed;
// a copy that never lands traps after ~8 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity = 0) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}
// `bytes` from global to shared memory by the TMA, completing on `bar`;
// both addresses and the size 16-byte aligned.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The same for a stream read once: marked first to leave the L2, so the
// split's partial outputs are still there when the combine reads them.
__device__ __forceinline__ void bulk_copy_stream(uint32_t dst, const void* src,
                                                 uint32_t bytes, uint32_t bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy) : "memory");
}

// ------------------------------------------------------- cache pieces to float32
// A 16-byte piece of a cache row: VEC elements.
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int VEC = 4;
  __device__ static void load(const uint8_t* p, float* out) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  }
};
__device__ __forceinline__ void bf16x2(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
template <> struct Piece<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void load(const uint8_t* p, float* out) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    bf16x2(t.x, out); bf16x2(t.y, out + 2); bf16x2(t.z, out + 4); bf16x2(t.w, out + 6);
  }
};
// Four int8 in a word to float32 exactly: x ^ 0x80 is k + 128 in 0..255;
// `__byte_perm` sets it as the low byte of 0x4B000000 (2^23), whose float
// is 2^23 + k + 128; one subtraction leaves k.
__device__ __forceinline__ void s8x4(uint32_t w, float* out) {
  constexpr float MAGIC = 8388736.0f;  // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - MAGIC;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - MAGIC;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - MAGIC;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - MAGIC;
}
template <> struct Piece<int8_t> {
  static constexpr int VEC = 16;
  __device__ static void load(const uint8_t* p, float* out) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    s8x4(t.x, out); s8x4(t.y, out + 4); s8x4(t.z, out + 8); s8x4(t.w, out + 12);
  }
};

// Four consecutive elements of a cache row (the P V phase's share of a lane).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  bf16x2(t.x, out); bf16x2(t.y, out + 2);
}
__device__ __forceinline__ void load4(const int8_t* p, float* out) {
  s8x4(*reinterpret_cast<const uint32_t*>(p), out);
}

template <int W>
__device__ __forceinline__ float sum_lanes(float x) {  // over aligned groups of W lanes
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pass 1: one block per (chunk, kv head x group tile, batch row).  Writes
// the chunk's unnormalised output acc[D] and its (m, l) for each of its GT
// query rows.  ks/vs are null for a float cache.
template <typename QT, typename KT, int D, int GT>
__global__ void __launch_bounds__(NT)
decode_split(const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ cur_index, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int KV, int G, int S, long long sb,
             long long skv, long long ss, int n_split, float scale) {
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  constexpr int CHUNK = chunk_rows<KT, D>();
  constexpr int RB = D * static_cast<int>(sizeof(KT));  // bytes of a cache row
  // scores: L lanes a row, PL 16-byte pieces a lane
  constexpr int VEC = Piece<KT>::VEC;
  constexpr int PIECES = D / VEC;
  constexpr int L = PIECES < 2 * GT ? PIECES : 2 * GT;
  constexpr int PL = PIECES / L;
  constexpr int RPW = 32 / L;  // rows a warp takes per step
  // P V: LP lanes a row, 4 columns a lane
  constexpr int LP = D / 4;
  constexpr int RPV = 32 / LP;
  static_assert(PIECES % L == 0 && (PL & (PL - 1)) == 0 && 32 % L == 0, "score split");
  static_assert(32 % LP == 0, "P V split");
  static_assert(CHUNK % 4 == 0 && NW * GT * D * 4 <= TILE_BYTES, "tile reuse");

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* k_tile = smem;
  uint8_t* v_tile = smem + TILE_BYTES;
  float* s_p = reinterpret_cast<float*>(smem + 2 * TILE_BYTES);  // [GT][CHUNK]
  float* s_q = s_p + GT * CHUNK;                                  // [GT][D]
  float* s_ks = s_q + GT * D;                                     // [CHUNK], int8
  float* s_vs = s_ks + (kInt8 ? CHUNK : 0);
  float* s_wm = s_vs + (kInt8 ? CHUNK : 0);                       // [NW][GT]
  float* s_wl = s_wm + NW * GT;                                   // [NW][GT]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_wl + NW * GT + 2); // 8-byte aligned
  float* s_red = reinterpret_cast<float*>(k_tile);  // [NW][GT][D] once K is read

  const int split = blockIdx.x;
  const int n_gt = (G + GT - 1) / GT;
  const int kvh = blockIdx.y / n_gt;
  const int g0 = (blockIdx.y % n_gt) * GT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  // this block's q, requested first: a load issued behind the bulk copies
  // returns only after their bytes
  constexpr int QN = (GT * D + NT - 1) / NT;
  float qv[QN];
#pragma unroll
  for (int u = 0; u < QN; ++u) {
    const int idx = tid + u * NT, g = idx / D;
    qv[u] = idx < GT * D && g0 + g < G
                ? to_f32(q[(((size_t)b * KV + kvh) * G + g0 + g) * D + idx % D])
                : 0.f;
  }
  const int cur = min(cur_index[b], S - 1);
  const int start = split * CHUNK;
  if (start > cur) return;  // past the valid prefix: the combine skips it
  const int n = min(CHUNK, cur + 1 - start);

  const int lane = tid % 32, warp = tid / 32;
  const int r = lane / L, c = lane % L;  // the score phase's row and lane in it
  const KT* kb = k + b * sb + kvh * skv + (long long)start * ss;
  const KT* vb = v + b * sb + kvh * skv + (long long)start * ss;
  const float* ksb = kInt8 ? ks + ((size_t)b * KV + kvh) * S + start : nullptr;
  const float* vsb = kInt8 ? vs + ((size_t)b * KV + kvh) * S + start : nullptr;
  // int8 scales by bulk copy where aligned: m >= n positions, never past S;
  // both come with K, since the softmax folds in the v scale
  const int m = kInt8 ? min((n + 3) & ~3, S - start) : 0;
  const bool bulk_scales = kInt8 && (m & 3) == 0 &&
                           ((reinterpret_cast<uintptr_t>(ksb) |
                             reinterpret_cast<uintptr_t>(vsb)) & 15) == 0;
  const uint32_t tile_bytes = n * RB;
  const uint32_t scale_bytes = bulk_scales ? m * 4 : 0;
  const uint32_t bar_k = smem_u32(&bars[0]), bar_v = smem_u32(&bars[1]);
  if (tid == 0) {
    mbar_init(bar_k);
    mbar_init(bar_v);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_k, tile_bytes + 2 * scale_bytes);
    mbar_expect_tx(bar_v, tile_bytes);
    if (ss == D) {  // a chunk's rows are contiguous: one copy each
      bulk_copy_stream(smem_u32(k_tile), kb, tile_bytes, bar_k);
      bulk_copy_stream(smem_u32(v_tile), vb, tile_bytes, bar_v);
    }
    if (bulk_scales) {
      bulk_copy(smem_u32(s_ks), ksb, scale_bytes, bar_k);
      bulk_copy(smem_u32(s_vs), vsb, scale_bytes, bar_k);
    }
  }
  // q, scaled, in float32, for every thread to take its pieces from
#pragma unroll
  for (int u = 0; u < QN; ++u)
    if (tid + u * NT < GT * D) s_q[tid + u * NT] = qv[u] * scale;
  __syncthreads();  // the barriers are initialised, q is in place
  if (ss != D) {  // one copy per row, spread over the block's threads
    for (int i = tid; i < n; i += NT)
      bulk_copy_stream(smem_u32(k_tile + i * RB), kb + i * ss, RB, bar_k);
    for (int i = tid; i < n; i += NT)
      bulk_copy_stream(smem_u32(v_tile + i * RB), vb + i * ss, RB, bar_v);
  }
  // this lane's q pieces, in the rotated order its rows are read in, while
  // the copies are in flight
  float qr[GT][PL][VEC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int j = 0; j < PL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        load4(s_q + g * D + (c + L * ((j + r) & (PL - 1))) * VEC + e, &qr[g][j][e]);
  if (kInt8 && !bulk_scales) {  // unaligned scales (S not a multiple of 4)
    for (int i = tid; i < n; i += NT) {
      s_ks[i] = ksb[i];
      s_vs[i] = vsb[i];
    }
    __syncthreads();
  }

  // 1. scores of the chunk's rows, once K has landed; every lane runs every
  //    step, so the shuffles see whole warps
  mbar_wait(bar_k);
  float mx[GT];  // the largest score of this lane's rows
#pragma unroll
  for (int g = 0; g < GT; ++g) mx[g] = NEG_INF;
#pragma unroll 2
  for (int base = 0; base < n; base += NW * RPW) {
    const int i = base + warp * RPW + r;
    // past the last row, lanes repeat it (no branch, no stale shared
    // memory) and drop the result
    const uint8_t* row = k_tile + min(i, n - 1) * RB;
    float part[GT][4];  // four chains of FMAs per query row
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[g][e] = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      float kv[VEC];
      Piece<KT>::load(row + (c + L * ((j + r) & (PL - 1))) * 16, kv);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part[g][e & 3] = fmaf(qr[g][j][e], kv[e], part[g][e & 3]);
    }
    float dot[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g)
      dot[g] = sum_lanes<L>((part[g][0] + part[g][1]) + (part[g][2] + part[g][3]));
    if (i < n) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float sc = kInt8 ? dot[g] * s_ks[i] : dot[g];
        mx[g] = fmaxf(mx[g], sc);
        if (c == 0) s_p[g * CHUNK + i] = sc;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o = 16; o >= L; o >>= 1)  // a row's L lanes hold the same scores
      mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
    if (lane == 0) s_wm[warp * GT + g] = mx[g];
  }
  __syncthreads();

  // 2. the chunk's softmax over all threads: m, the largest score, and l,
  //    the sum of e^(s - m), each warp's share of l summed in order at the
  //    end; int8 folds the v scale into the stored probabilities
  float lw[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    mx[g] = s_wm[g];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx[g] = fmaxf(mx[g], s_wm[w * GT + g]);
    lw[g] = 0.f;
  }
  for (int i = tid; i < n; i += NT) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float e = expf(s_p[g * CHUNK + i] - mx[g]);
      lw[g] += e;
      s_p[g * CHUNK + i] = kInt8 ? e * s_vs[i] : e;
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    lw[g] = sum_lanes<32>(lw[g]);
    if (lane == 0) s_wl[warp * GT + g] = lw[g];
  }
  __syncthreads();

  // 3. acc[g][d] = sum_i p[g][i] v[i][d]: warp w takes rows w*RPV + h of
  //    every NW*RPV, a lane 4 columns
  mbar_wait(bar_v);
  const int h = lane / LP, cq = lane % LP;
  float acc[GT][4];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  const KT* vt = reinterpret_cast<const KT*>(v_tile) + cq * 4;
#pragma unroll 4
  for (int base = 0; base < n; base += NW * RPV) {
    const int i = base + warp * RPV + h;
    const int ic = min(i, n - 1);  // past the last row: its values times 0
    float vv[4];
    load4(vt + ic * D, vv);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float p = i < n ? s_p[g * CHUNK + ic] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
    }
  }
  // sum over the rows a warp holds, then over the warps (in shared memory
  // where K was: every thread is past the scores)
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = acc[g][e];
#pragma unroll
      for (int o = LP; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      acc[g][e] = x;
    }
  if (h == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_red[(warp * GT + g) * D + cq * 4 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = tid; idx < GT * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    if (g0 + g >= G) continue;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) x += s_red[(w * GT + g) * D + d];
    const size_t row = ((size_t)b * KV + kvh) * G + g0 + g;
    part_acc[(row * n_split + split) * D + d] = x;
    if (d < 2) {  // m, or l summed over the warps in order
      float y = d == 0 ? s_wm[g] : s_wl[g];
#pragma unroll
      for (int w = 1; w < NW; ++w)
        y = d == 0 ? fmaxf(y, s_wm[w * GT + g]) : y + s_wl[w * GT + g];
      part_ml[(row * n_split + split) * 2 + d] = y;
    }
  }
  // the combine may start once every block has written its partials
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Pass 2, launched behind the split as a programmatic dependent: one block
// per query row combines the chunks up to cur_index[b], in ascending order:
// out = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M).  The row's partial
// outputs come in by bulk copies, a stage of CS chunks at a time, with up to
// CSTAGES stages in flight; a thread sums one column.
template <typename OT, int CHUNK, int D>
__global__ void __launch_bounds__(CT)
decode_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               const int* __restrict__ cur_index, OT* __restrict__ out, int rows_per_b,
               int S, int n_split) {
  constexpr int CS = COMBINE_STAGE_BYTES / (D * 4);  // chunks per stage
  __shared__ __align__(128) float s_acc[CSTAGES][CS][D];
  __shared__ float s_w[CS], s_l[CS], s_m[CT / 32];
  __shared__ uint64_t bars[CSTAGES];
  const size_t r = blockIdx.x;
  const int tid = threadIdx.x;
  const int cur = min(cur_index[r / rows_per_b], S - 1);  // not the split's output
  if (cur < 0) {  // no valid position: zeros, as the TPU kernel gives
    for (int d = tid; d < D; d += CT) store(out + r * D + d, 0.f);
    return;
  }
  const int nv = cur / CHUNK + 1;
  const int n_stages = (nv + CS - 1) / CS;
  const float* ml = part_ml + r * n_split * 2;
  const float* pa = part_acc + r * n_split * D;
  auto issue = [&](int st) {  // stage st into its buffer, by thread 0
    const int cnt = min(CS, nv - st * CS);
    const uint32_t bar = smem_u32(&bars[st % CSTAGES]);
    mbar_expect_tx(bar, cnt * D * 4);
    bulk_copy(smem_u32(&s_acc[st % CSTAGES][0][0]), pa + (size_t)st * CS * D, cnt * D * 4,
              bar);
  };
  if (tid == 0) {
    for (int i = 0; i < CSTAGES; ++i) mbar_init(smem_u32(&bars[i]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the split's partials are written
  // M, its first loads ahead of the bulk copies (a load issued behind them
  // returns after their bytes), the rest while they are in flight
  const float m_t = tid < nv ? ml[2 * tid] : NEG_INF;  // chunk tid's (m, l)
  const float l_t = tid < nv ? ml[2 * tid + 1] : 0.f;
  float mx = m_t;
  if (tid == 0)
    for (int st = 0; st < min(n_stages, CSTAGES); ++st) issue(st);
  for (int j = tid + CT; j < nv; j += CT) mx = fmaxf(mx, ml[2 * j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (tid % 32 == 0) s_m[tid / 32] = mx;
  __syncthreads();
  mx = s_m[0];
#pragma unroll
  for (int w = 1; w < CT / 32; ++w) mx = fmaxf(mx, s_m[w]);

  const int d = tid;
  float l = 0.f, acc = 0.f;
  for (int st = 0; st < n_stages; ++st) {
    const int cnt = min(CS, nv - st * CS);
    if (tid < cnt) {
      const int j = st * CS + tid;
      s_w[tid] = expf((st == 0 ? m_t : ml[2 * j]) - mx);
      s_l[tid] = st == 0 ? l_t : ml[2 * j + 1];
    }
    __syncthreads();
    mbar_wait(smem_u32(&bars[st % CSTAGES]), (st / CSTAGES) & 1);
    if (d < D) {
      const float* a = &s_acc[st % CSTAGES][0][d];
      for (int j = 0; j < cnt; ++j) {
        l = fmaf(s_l[j], s_w[j], l);
        acc = fmaf(a[j * D], s_w[j], acc);
      }
    }
    __syncthreads();  // the buffer and the weights are used
    if (tid == 0 && st + CSTAGES < n_stages) issue(st + CSTAGES);
  }
  if (d < D) store(out + r * D + d, acc / fmaxf(l, 1e-30f));
}

template <typename QT, typename KT, int D, int GT>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* cur, void* out, float* part_acc,
                   float* part_ml, int B, int KV, int G, int S, long long sb,
                   long long skv, long long ss, float scale, cudaStream_t stream) {
  constexpr int CHUNK = chunk_rows<KT, D>();
  constexpr int SMEM = split_smem_bytes<KT, GT, D>();
  // above 48 KB of shared memory, once per device
  static std::atomic<unsigned> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(decode_split<QT, KT, D, GT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  const int n_split = (S + CHUNK - 1) / CHUNK;
  const int n_gt = (G + GT - 1) / GT;
  decode_split<QT, KT, D, GT><<<dim3(n_split, KV * n_gt, B), NT, SMEM, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      ks, vs, cur, part_acc, part_ml, KV, G, S, sb, skv, ss, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * G);
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_combine<QT, CHUNK, D>, part_acc, part_ml, cur,
                           static_cast<QT*>(out), KV * G, S, n_split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename QT, typename KT, int D>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const int* cur, void* out, float* part_acc,
                     float* part_ml, int B, int KV, int S, long long sb, long long skv,
                     long long ss, float scale, cudaStream_t stream) {
  if (G <= 2)
    return launch<QT, KT, D, 2>(q, k, v, ks, vs, cur, out, part_acc, part_ml, B, KV, G,
                                S, sb, skv, ss, scale, stream);
  return launch<QT, KT, D, 4>(q, k, v, ks, vs, cur, out, part_acc, part_ml, B, KV, G, S,
                              sb, skv, ss, scale, stream);
}

template <typename QT, typename KT>
cudaError_t launch_d(int D, int G, const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* cur, void* out,
                     float* part_acc, float* part_ml, int B, int KV, int S, long long sb,
                     long long skv, long long ss, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_g<QT, KT, 32>(G, q, k, v, ks, vs, cur, out, part_acc, part_ml,
                                         B, KV, S, sb, skv, ss, scale, stream);
    case 64: return launch_g<QT, KT, 64>(G, q, k, v, ks, vs, cur, out, part_acc, part_ml,
                                         B, KV, S, sb, skv, ss, scale, stream);
    case 128: return launch_g<QT, KT, 128>(G, q, k, v, ks, vs, cur, out, part_acc,
                                           part_ml, B, KV, S, sb, skv, ss, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KT>
int chunk_for(int D) {
  return D == 32 ? chunk_rows<KT, 32>() : D == 64 ? chunk_rows<KT, 64>()
                                        : D == 128 ? chunk_rows<KT, 128>() : 0;
}

}  // namespace

// C entry points, bound with ctypes.  dtype codes: 0 float32, 1 bfloat16.
// Strides are in elements; with C = repro_decode_attention_chunk(cache
// element bytes, D), part_acc holds B*KV*G*ceil(S/C)*D floats and part_ml
// B*KV*G*ceil(S/C)*2.  Return a cudaError_t; 0 on success.
extern "C" int repro_decode_attention_chunk(int elem_bytes, int D) {
  if (elem_bytes == 1) return chunk_for<int8_t>(D);
  if (elem_bytes == 2) return chunk_for<__nv_bfloat16>(D);
  if (elem_bytes == 4) return chunk_for<float>(D);
  return 0;
}

extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* cur, void* out, float* part_acc,
                                      float* part_ml, int B, int KV, int G, int S, int D,
                                      long long sb, long long skv, long long ss,
                                      int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float, float>(D, G, q, k, v, nullptr, nullptr, cur, out, part_acc,
                                  part_ml, B, KV, S, sb, skv, ss, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, G, q, k, v, nullptr, nullptr, cur,
                                                  out, part_acc, part_ml, B, KV, S, sb,
                                                  skv, ss, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int repro_decode_attention_int8(const void* q, const void* k, const void* v,
                                           const float* ks, const float* vs,
                                           const int* cur, void* out, float* part_acc,
                                           float* part_ml, int B, int KV, int G, int S,
                                           int D, long long sb, long long skv,
                                           long long ss, int q_dtype, float scale,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_d<float, int8_t>(D, G, q, k, v, ks, vs, cur, out, part_acc, part_ml, B,
                                   KV, S, sb, skv, ss, scale, st);
  if (q_dtype == 1)
    return launch_d<__nv_bfloat16, int8_t>(D, G, q, k, v, ks, vs, cur, out, part_acc,
                                           part_ml, B, KV, S, sb, skv, ss, scale, st);
  return cudaErrorInvalidValue;
}
