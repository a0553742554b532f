// Per-column and per-document EMVB math shared by the fused kernels
// (prefilter.cu, pqinter.cu) and the unfused ones (bitpack.cu, bitfilter.cu,
// cinter.cu, pqscore.cu). The reference shares sbar_block between cinter.py
// and pqinter.py, and eq56_block between pqscore.py and pqinter.py, "in
// lockstep"; here both lanes build their documents' scores from these
// pieces, so they give the same bits by construction.
//
// Bit-exact rules kept here: float32 compares, no fast math, the residual
// starts from the s = 0 gather and adds s = 1..m-1 in order, the centroid
// score is added to the residual, term_sum is lane 0 + lane 1 + ... in
// serial shuffles, and the reference's -1e9 floor enters a per-term max
// once per document, in the finishing step, only when the doc has invalid
// tokens (len < cap). A per-term max and Eq. 6's kept max and kept count
// are order-free, so a document's tokens may be split over warps and their
// partial states merged (eq56_merge, sbar_token): the result is the same
// value whatever the split. Which of two equal maxima is kept does depend
// on the split, which shows only for a -0.0 beside a 0.0 or for NaN; the
// port's inputs exclude both (ROADMAP Queue 3, "Signed zeros and NaN").
//
// CS and CS^T are float32 or bf16 (cs_dtype="bfloat16", paper §6): every
// function that reads them takes the element type T (Cs<T> below), widens
// each value in registers (exactly) and computes in float32. Thresholds
// arrive rounded on the host to the value the reference compares against,
// so each compare is one of float32 values. What bf16 changes beyond the
// read is S̄'s: an invalid token is the bf16 -1e9, and term_sum's float32
// chain is rounded once to bf16 (the reference's term_sum of half
// precision), then widened again. Eq. 5/6 adds the widened bf16 centroid
// score to the float32 residual, as the reference's eq56_block does.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace emvb {

constexpr float NEG = -1e9f;   // an invalid token's score in every max

// --- CS element types -----------------------------------------------------------

template <typename T>
struct Cs;

template <>
struct Cs<float> {
  static constexpr int kVec = 4;   // elements in 16 bytes
  static __device__ __forceinline__ float widen(float v) { return v; }
  // the 16 bytes r as kVec values, in memory order
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[kVec]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  // S̄'s floor for invalid tokens, and its term sum as the reference
  // rounds it
  static __device__ __forceinline__ float neg() { return NEG; }
  static __device__ __forceinline__ float round_sum(float s) { return s; }
};

template <>
struct Cs<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  // a bf16 value is the high half of its float32 (little-endian pairs)
  static __device__ __forceinline__ void unpack(uint4 r, float (&f)[kVec]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float neg() {
    return __bfloat162float(__float2bfloat16_rn(NEG));
  }
  static __device__ __forceinline__ float round_sum(float s) {
    return __bfloat162float(__float2bfloat16_rn(s));
  }
};

// --- Phase 1b: bit words ------------------------------------------------------

// Query b's row of a (B, n_q) term mask, or null when the mask is null
// (every term live): the one encoding of an absent mask in every kernel.
__device__ __forceinline__ const uint8_t* mask_row(
    const uint8_t* __restrict__ qmask, int b, int n_q) {
  return qmask == nullptr ? nullptr : qmask + (size_t)b * n_q;
}

// Bit i = term i is live: qm[i] != 0, or i < n_q when qm is null.
__device__ __forceinline__ uint32_t live_terms(const uint8_t* __restrict__ qm,
                                               int n_q) {
  uint32_t live = 0;
  for (int i = 0; i < n_q; ++i)
    if (qm == nullptr || qm[i]) live |= 1u << i;
  return live;
}

// One centroid column: bit i = term i is live and cs[i, c] > th. `col`
// points at cs[0, c]; term rows are `stride` elements apart.
template <typename T>
__device__ __forceinline__ uint32_t pack_column(const T* __restrict__ col,
                                                size_t stride, float th,
                                                uint32_t live, int n_q) {
  uint32_t w = 0;
  for (int i = 0; i < n_q; ++i)
    if (Cs<T>::widen(col[(size_t)i * stride]) > th) w |= 1u << i;
  return w & live;
}

// Cs<T>::kVec neighbouring columns at once (4 float32 or 8 bf16; col
// 16-byte aligned, stride a multiple of kVec): the same bits as kVec
// pack_column calls, with one 16-byte load per term.
template <typename T>
__device__ __forceinline__ void pack_columns(const T* __restrict__ col,
                                             size_t stride, float th,
                                             uint32_t live, int n_q,
                                             uint32_t (&w)[Cs<T>::kVec]) {
  constexpr int V = Cs<T>::kVec;
#pragma unroll
  for (int j = 0; j < V; ++j) w[j] = 0;
#pragma unroll 8
  for (int i = 0; i < n_q; ++i) {
    float v[V];
    Cs<T>::unpack(*reinterpret_cast<const uint4*>(col + (size_t)i * stride),
                  v);
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] |= (uint32_t)(v[j] > th) << i;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) w[j] &= live;
}

// --- Eq. 4: a document's word OR ------------------------------------------------

// The transposed word table the dense form reads: bits (B, n_c) -> bitsT
// (n_c, B). One block of 256 threads per 32 columns, through shared
// memory, so the reads of bits are whole 128-byte lines and the writes of
// bitsT whole rows. When occ is not null (bitfilter.cu), bit c % 32 of
// occ[c / 32] is also set when row c has a bit set: the block's 32 columns
// give one word.
__device__ __forceinline__ void transpose_words(
    const uint32_t* __restrict__ bits, int B, int n_c,
    uint32_t* __restrict__ bitsT, uint32_t* __restrict__ occ = nullptr) {
  __shared__ uint32_t t[32][33];
  const int c0 = blockIdx.x * 32, x = threadIdx.x & 31, y = threadIdx.x >> 5;
  for (int b = y; b < B; b += blockDim.x >> 5)
    if (c0 + x < n_c) t[b][x] = bits[(size_t)b * n_c + c0 + x];
  __syncthreads();
  for (int j = y; j < 32; j += blockDim.x >> 5)
    if (c0 + j < n_c && x < B) bitsT[(size_t)(c0 + j) * B + x] = t[x][j];
  if (occ != nullptr && y == 0) {
    uint32_t row = 0;
    if (c0 + x < n_c)
      for (int b = 0; b < B; ++b) row |= t[b][x];
    const uint32_t w = __ballot_sync(FULL_MASK, row != 0);
    if (x == 0) occ[blockIdx.x] = w;
  }
}

// Dense form, every query at once (the fused prefilter's docs with many
// candidate queries): a warp's lanes split into (token group g, query bq)
// pairs, Q lanes per group (Q >= B, a power of two) and G = 32 / Q
// groups: lane (g, bq) ORs query bq's words of tokens g, g + G, ...
// from the transposed (n_c, B) word table, and the shuffles fold the
// groups, so each lane of query bq ends with the doc's word. Lanes with
// `active` false gather nothing but join the shuffles; all 32 lanes must
// call it.
__device__ __forceinline__ uint32_t doc_word_or(
    const int32_t* __restrict__ cd, int len, int n_c,
    const uint32_t* __restrict__ bitsT, int B, int bq, int g, int G, int Q,
    bool active) {
  uint32_t acc = 0;
  if (active) {
#pragma unroll 4
    for (int tok = g; tok < len; tok += G) {
      const int c = min(max(cd[tok], 0), n_c - 1);
      acc |= bitsT[(size_t)c * B + bq];
    }
  }
  for (int o = Q; o < 32; o <<= 1) acc |= __shfl_xor_sync(FULL_MASK, acc, o);
  return acc;
}

// Sparse form, one or two queries over tokens spread across lanes (the
// fused prefilter): lane l holds the clamped codes c[r] of tokens
// r * 32 + l, or -1 for a token past the doc's length; *a1 (and *a2 when
// w2 is not null) get the OR across the warp of w1's (w2's) words at those
// codes. Every lane's gathers are in flight together. All 32 lanes must
// call it with the same w1, w2.
template <int R>
__device__ __forceinline__ void chunk_word_or(const uint32_t* __restrict__ w1,
                                              const uint32_t* __restrict__ w2,
                                              const int (&c)[R], uint32_t* a1,
                                              uint32_t* a2) {
  uint32_t x1 = 0, x2 = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (c[r] >= 0) {
      x1 |= __ldcg(w1 + c[r]);
      if (w2 != nullptr) x2 |= __ldcg(w2 + c[r]);
    }
  }
  *a1 = __reduce_or_sync(FULL_MASK, x1);
  *a2 = w2 != nullptr ? __reduce_or_sync(FULL_MASK, x2) : 0u;
}

// Lit-rows form, every query at once (bitfilter.cu). A warp walks a group
// of 32 docs' codes as one flat run, VEC neighbouring codes a lane, all of
// one doc t (so t does not fall from lane to lane), and ORs into sW[t * P
// + b] (the group's words in shared memory, P >= B) query b's words of the
// codes whose row of the transposed (n_c, B) word table is lit. c = the
// lane's clamped codes; lit = which of them are valid tokens with a lit
// row; the caller skips a round with no lit code. A round's docs are runs
// of lanes.
//  * B = 1: each lane ORs the words of its own lit codes, all in flight
//    together, and one warp reduction per run gives the run's word.
//  * B > 1: the lit codes go, in flat order, to the warp's `list` (32 *
//    VEC ints), and the lanes split into (token group g, query bq) pairs as
//    in the dense form: lane (g, bq) ORs query bq's words of a run's
//    entries g, g + G, ..., the loads unrolled so that several rows are in
//    flight, and adds its OR to sW.
// All 32 lanes must call it.
template <int VEC>
__device__ __forceinline__ void lit_rows_or(
    const int (&c)[VEC], const bool (&lit)[VEC], int t,
    const uint32_t* __restrict__ bitsT, int B, int P, int bq, int g, int G,
    int* list, uint32_t* sW) {
  const int lane = threadIdx.x & 31;
  const int t_up = __shfl_up_sync(FULL_MASK, t, 1);
  uint32_t runs = __ballot_sync(FULL_MASK, lane == 0 || t != t_up);
  if (B == 1) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (lit[k]) w |= bitsT[c[k]];
    while (runs) {                                 // warp-uniform
      const int h = __ffs(runs) - 1;
      runs &= runs - 1;
      const int end = runs ? __ffs(runs) - 1 : 32;
      const uint32_t x =
          __reduce_or_sync(FULL_MASK, lane >= h && lane < end ? w : 0u);
      const int td = __shfl_sync(FULL_MASK, t, h);
      if (lane == 0 && x) sW[td * P] |= x;
    }
    __syncwarp();
    return;
  }
  const uint32_t below = (1u << lane) - 1u;
  int at = 0, n = 0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const uint32_t mk = __ballot_sync(FULL_MASK, lit[k]);
    at += __popc(mk & below);
    n += __popc(mk);
  }
  const int first = at;                 // the lane's first entry
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (lit[k]) list[at++] = c[k];
  __syncwarp();
  while (runs) {                                   // warp-uniform
    const int h = __ffs(runs) - 1;
    runs &= runs - 1;
    const int s = __shfl_sync(FULL_MASK, first, h);
    const int e = runs ? __shfl_sync(FULL_MASK, first, __ffs(runs) - 1) : n;
    const int td = __shfl_sync(FULL_MASK, t, h);
    if (bq < B && s < e) {
      uint32_t acc = 0;
#pragma unroll 8
      for (int j = s + g; j < e; j += G)
        acc |= bitsT[(size_t)list[j] * B + bq];
      if (acc) atomicOr(sW + td * P + bq, acc);
    }
  }
  __syncwarp();
}

// --- term_sum -------------------------------------------------------------------

// term_sum over a warp holding one term per lane: lane 0 + lane 1 + ... +
// lane n_q-1, in that order (a shuffle tree would change bits). The 32
// shuffles are issued first, so only the adds wait on each other. All 32
// lanes must call it; every lane gets the sum.
__device__ __forceinline__ float term_sum_lanes(float colmax, int n_q) {
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = __shfl_sync(FULL_MASK, colmax, i);
  float s = v[0];
#pragma unroll
  for (int i = 1; i < 32; ++i)
    if (i < n_q) s = s + v[i];
  return s;
}

// --- S̄ (Eq. 2) ------------------------------------------------------------------

// A per-term max over tokens, started at -INFINITY: one token's CS^T value,
// or another warp's partial max.
__device__ __forceinline__ float sbar_token(float acc, float v) {
  return v > acc ? v : acc;
}

// The per-term max over all of a doc's valid tokens -> the term's column
// max: the -1e9 floor (in T) when the doc has invalid tokens, 0.0 for a
// masked term.
template <typename T>
__device__ __forceinline__ float sbar_finish(float acc, int len, int cap,
                                             bool live) {
  if (len < cap) acc = acc > Cs<T>::neg() ? acc : Cs<T>::neg();
  return live ? acc : 0.0f;
}

// S̄ from the finished column maxima, one term a lane: term_sum, rounded
// as the reference rounds it for T. All 32 lanes must call it.
template <typename T>
__device__ __forceinline__ float sbar_sum(float colmax, int n_q) {
  return Cs<T>::round_sum(term_sum_lanes(colmax, n_q));
}

// The S̄ pass (Eq. 2) of every doc of a (B, nd, cap) code array, which the
// unfused cinter.cu and the fused pqinter.cu's pass 1 both launch. A block
// of SBAR_WARPS warps scores SBAR_WARPS / split docs, `split` warps a doc,
// each over a contiguous run of ceil(cap / split) of the doc's token slots.
// Per warp, the codes arrive up to 128 at a time, 32 a coalesced load,
// issued beside the doc's length (so the two loads are in flight
// together), clamped as jnp.clip does, and go from lane to lane by
// shuffles: no row gather waits on a code load of its own. Then rounds of
// SBAR_K gathers, all issued before the round's first max. Two forms,
// chosen on the host from the shape and the pointer (sbar_launch):
//  * 16-byte rows (LP > 0): when a row of CS^T (n_q * sizeof(T) bytes) is a
//    whole number of 16-byte pieces at a 16-byte-aligned base, LP lanes (a
//    power of two) hold one row, a piece each (4 float32 or 8 bf16 terms),
//    so one warp load gathers 32 / LP tokens' rows. Each lane keeps its
//    group's per-term maxima; shuffles merge the groups and then move term
//    i to lane i.
//  * one lane per term (LP = 0), any other row width or base: a 4- or
//    2-byte gather per (token, term), SBAR_K tokens a round.
// Then the warps of a doc merge through shared memory, and its first warp
// finishes (sbar_finish) and term-sums (sbar_sum). A per-term max is
// order-free, so every form and split gives the same bits. The pass waits
// on latency: on the H100 more resident warps with SBAR_K = 4 gathers each
// beat fewer warps with 8 (PERF.md, PR 17).
constexpr int SBAR_WARPS = 8;        // 256 threads a block
constexpr int SBAR_MIN_BLOCKS = 6;   // blocks an SM at least: <= 40 regs
constexpr int SBAR_SPLIT_MAX = 8;    // warps per doc, at most
constexpr int SBAR_K = 4;            // gathers a lane issues a round
constexpr int SBAR_CODES = 128;      // codes a warp holds at least
static_assert(SBAR_WARPS % SBAR_SPLIT_MAX == 0, "whole docs a block");

// Tokens a warp gathers in one round: SBAR_K warp loads of 32 / LP rows,
// or SBAR_K tokens one lane per term (LP = 0).
__host__ __device__ constexpr int sbar_round(int lp) {
  return lp > 0 ? SBAR_K * (32 / lp) : SBAR_K;
}

// A warp's codes of token slots [b0, b0 + 32 * NR): lane l holds slot
// b0 + 32 * r + l in c[r], read when below `end` (a bound known before the
// doc's length arrives) and then kept, clamped, when below `hi`, else -1.
template <int NR>
__device__ __forceinline__ void sbar_codes(const int32_t* __restrict__ cd,
                                           int b0, int end, int hi, int n_c,
                                           int (&c)[NR]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int t = b0 + 32 * r + lane;
    c[r] = t < end ? cd[t] : 0;
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int t = b0 + 32 * r + lane;
    c[r] = t < hi ? min(max(c[r], 0), n_c - 1) : -1;
  }
}

// One warp's per-term max over the valid tokens of the slots [lo, end) of
// a doc of `len` tokens, the 16-byte form: cb = the query's (n_c, n_q)
// CS^T, cd = the doc's codes. Lane l returns term l's max (lanes >= n_q:
// no term's). All 32 lanes must call it with the same lo, end and len.
template <typename T, int LP>
__device__ __forceinline__ float sbar_span_rows(const T* __restrict__ cb,
                                                const int32_t* __restrict__ cd,
                                                int lo, int end, int len,
                                                int n_c, int n_q) {
  constexpr int V = Cs<T>::kVec;       // terms a lane loads
  constexpr int G = 32 / LP;           // tokens a warp load
  constexpr int S = sbar_round(LP);    // tokens a round
  constexpr int CB = S > SBAR_CODES ? S : SBAR_CODES;   // tokens a block
  constexpr int NR = CB / 32;          // codes a lane holds
  static_assert(CB % S == 0, "whole rounds a block");
  const int lane = threadIdx.x & 31, g = lane / LP, j = lane % LP;
  const bool piece = j * V < n_q;      // this lane's 16 bytes are in the row
  const T* rb = cb + j * V;
  const int hi = min(len, end);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = -INFINITY;
  for (int b0 = lo; b0 < end; b0 += CB) {        // warp-uniform
    int c[NR];
    sbar_codes<NR>(cd, b0, end, hi, n_c, c);
    if (b0 >= hi) break;
#pragma unroll
    for (int q = 0; q < CB / S; ++q) {
      if (b0 + q * S >= hi) break;               // warp-uniform
      uint4 raw[SBAR_K];
      bool ok[SBAR_K];
#pragma unroll
      for (int k = 0; k < SBAR_K; ++k) {  // slot q * S + k * G + g
        const int ck = __shfl_sync(FULL_MASK, c[(q * S + k * G) / 32],
                                   (q * S + k * G) % 32 + g);
        ok[k] = piece && ck >= 0;
        raw[k] = ok[k] ? __ldg(reinterpret_cast<const uint4*>(
                             rb + (size_t)ck * n_q))
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < SBAR_K; ++k) {
        if (!ok[k]) continue;
        float f[V];
        Cs<T>::unpack(raw[k], f);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = sbar_token(acc[v], f[v]);
      }
    }
  }
#pragma unroll
  for (int o = LP; o < 32; o <<= 1)              // merge the token groups
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc[v] = sbar_token(acc[v], __shfl_xor_sync(FULL_MASK, acc[v], o));
  // term i = piece i / V, value i % V: on lane i / V of every group
  float col = -INFINITY;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float x = __shfl_sync(FULL_MASK, acc[v], lane / V);
    if (lane % V == v) col = x;
  }
  return col;
}

// The same, one lane per term (lane l = term l): a gather of one element
// per (token, term), SBAR_K tokens' gathers issued before their maxima.
template <typename T>
__device__ __forceinline__ float sbar_span_terms(
    const T* __restrict__ cb, const int32_t* __restrict__ cd, int lo,
    int end, int len, int n_c, int n_q) {
  constexpr int CB = SBAR_CODES, NR = CB / 32;
  static_assert(CB % SBAR_K == 0, "whole rounds a block");
  const int lane = threadIdx.x & 31;
  const bool term = lane < n_q;
  const T* tb = cb + lane;
  const int hi = min(len, end);
  float acc = -INFINITY;
  for (int b0 = lo; b0 < end; b0 += CB) {        // warp-uniform
    int c[NR];
    sbar_codes<NR>(cd, b0, end, hi, n_c, c);
    if (b0 >= hi) break;
#pragma unroll
    for (int k0 = 0; k0 < CB; k0 += SBAR_K) {
      if (b0 + k0 >= hi) break;                  // warp-uniform
      float v[SBAR_K];
#pragma unroll
      for (int k = 0; k < SBAR_K; ++k) {
        const int ck =
            __shfl_sync(FULL_MASK, c[(k0 + k) / 32], (k0 + k) % 32);
        v[k] = term && ck >= 0 ? Cs<T>::widen(tb[(size_t)ck * n_q])
                               : -INFINITY;
      }
#pragma unroll
      for (int k = 0; k < SBAR_K; ++k) acc = sbar_token(acc, v[k]);
    }
  }
  return acc;
}

// The S̄ pass's body: S̄ of doc p = blockIdx.x * (SBAR_WARPS / split) +
// warp / split of query b = blockIdx.y, written to out[b * nd + p]. cs_t
// (B, n_c, n_q) of T; codes (B, nd, cap); lens (B, nd); qmask (B, n_q) or
// null. LP as in sbar_span_rows, or 0 for one lane per term. Every thread
// of the block must call it.
template <int LP, typename T>
__device__ __forceinline__ void sbar_block(
    const T* __restrict__ cs_t, const int32_t* __restrict__ codes,
    const int32_t* __restrict__ lens, const uint8_t* __restrict__ qmask,
    int nd, int cap, int n_c, int n_q, int split, float* __restrict__ out) {
  __shared__ float part[SBAR_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int piece = warp % split;
  const int p = blockIdx.x * (SBAR_WARPS / split) + warp / split;
  const int b = blockIdx.y;
  const bool ok = p < nd;                              // warp-uniform
  const size_t row = (size_t)b * nd + p;
  float col = -INFINITY;
  int len = 0;
  if (ok) {
    const int span = (cap + split - 1) / split;
    const int lo = piece * span, end = min(cap, lo + span);
    len = min(max(lens[row], 0), cap);
    const T* cb = cs_t + (size_t)b * n_c * n_q;
    const int32_t* cd = codes + row * cap;
    if constexpr (LP > 0)
      col = sbar_span_rows<T, LP>(cb, cd, lo, end, len, n_c, n_q);
    else
      col = sbar_span_terms<T>(cb, cd, lo, end, len, n_c, n_q);
  }
  if (split > 1) {                                     // block-uniform
    part[warp][lane] = col;
    __syncthreads();
    if (piece != 0) return;
    for (int k = 1; k < split; ++k) col = sbar_token(col, part[warp + k][lane]);
  }
  if (!ok) return;
  const uint8_t* qm = mask_row(qmask, b, n_q);
  const bool live = lane < n_q && (qm == nullptr || qm[lane]);
  const float s = sbar_sum<T>(sbar_finish<T>(col, len, cap, live), n_q);
  if (lane == 0) out[row] = s;
}

// Host side of the S̄ pass: its grid, its warps per doc and its form.
struct SbarLaunch {
  dim3 grid;
  int split;   // warps per doc
  int lanes;   // LP of sbar_block: lanes per 16-byte-loaded row, or 0
};

// The 16-byte form runs when a row of cs_t is a whole number of 16-byte
// pieces (n_q % 4 == 0 in float32, % 8 in bf16) at a 16-byte-aligned base;
// LP is their count rounded up to a power of two. A doc's token slots are
// split over warps, a power of two, only while the batch's docs times the
// split fit the card in one wave (SBAR_MIN_BLOCKS blocks an SM: at B = 32
// the 32K survivors already take several, and a split would add merges; at
// B = 1 the 1,024 survivors take 4 warps each) and a warp would still
// gather more than one round (sbar_round).
template <typename T>
inline SbarLaunch sbar_launch(const T* cs_t, int B, int nd, int cap,
                              int n_q) {
  const size_t row = (size_t)n_q * sizeof(T);
  const bool rows = row % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cs_t) % 16 == 0;
  const int lanes = rows ? next_pow2((int)(row / 16)) : 0;
  const long long docs = (long long)B * nd;
  const long long resident =
      (long long)SBAR_MIN_BLOCKS * SBAR_WARPS * sm_count();
  const int round = sbar_round(lanes);
  int split = 1;
  while (split < SBAR_SPLIT_MAX && docs * 2 * split <= resident &&
         cap > split * round)
    split *= 2;
  const int per_block = SBAR_WARPS / split;
  return {dim3((nd + per_block - 1) / per_block, B), split, lanes};
}

// Calls f(std::integral_constant<int, LP>) for lanes = LP in {0, 1, 2, 4,
// 8}: a kernel templated on LP is launched inside f.
template <typename F>
inline void with_sbar_lanes(int lanes, F&& f) {
  switch (lanes) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    default: f(std::integral_constant<int, 0>{});
  }
}

// --- Eq. 5/6 -----------------------------------------------------------------------

// One term's Eq. 5/6 state over some of a doc's tokens.
struct Eq56Part {
  float full_max;   // max over the tokens of the full score
  float kept_max;   // Eq. 6: max over the tokens whose centroid beats th_r
  int n_keep;       // Eq. 6: how many tokens those are
};

__device__ __forceinline__ Eq56Part eq56_start() {
  return Eq56Part{-INFINITY, -INFINITY, 0};
}

// M bytes of residual codes at p (16-byte aligned, M a multiple of 16) as
// words.
template <int M>
__device__ __forceinline__ void load_code_words(const uint8_t* __restrict__ p,
                                                uint32_t (&w)[M / 4]) {
  static_assert(M % 16 == 0, "compile-time m is a multiple of 16");
#pragma unroll
  for (int k = 0; k < M / 16; ++k) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

// The full score of one (token, term): the centroid score plus the residual
// lut[s=0] + lut[s=1] + ... + lut[s=m-1], in that order. lb points at this
// lane's term in row 0 of the query's (m*ksub, n_q) LUT; rt at the token's
// m residual codes. M = m known at compile time (a multiple of 16): the
// codes arrive in vector loads and all m LUT reads are issued before the
// first add. M = 0: any m, read in series.
template <int M>
__device__ __forceinline__ float eq56_full(float cen,
                                           const float* __restrict__ lb,
                                           const uint8_t* __restrict__ rt,
                                           int m, int ksub, int n_q) {
  float resid;
  if constexpr (M == 0) {
    resid = lb[(size_t)rt[0] * n_q];
    for (int s = 1; s < m; ++s)
      resid = resid + lb[((size_t)s * ksub + rt[s]) * n_q];
  } else {
    uint32_t w[M / 4];
    load_code_words<M>(rt, w);
    float v[M];
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const uint32_t code = (w[s >> 2] >> (8 * (s & 3))) & 0xffu;
      v[s] = lb[((size_t)s * ksub + code) * n_q];
    }
    resid = v[0];
#pragma unroll
    for (int s = 1; s < M; ++s) resid = resid + v[s];
  }
  return cen + resid;
}

// Add one token (its centroid score and full score) to a term's state.
__device__ __forceinline__ void eq56_token(Eq56Part& p, float cen, float full,
                                           float th_r, int use_filter) {
  p.full_max = full > p.full_max ? full : p.full_max;
  if (use_filter && cen > th_r) {
    p.kept_max = full > p.kept_max ? full : p.kept_max;
    ++p.n_keep;
  }
}

// Merge another warp's state of the same term and doc into p.
__device__ __forceinline__ void eq56_merge(Eq56Part& p, const Eq56Part& o) {
  p.full_max = o.full_max > p.full_max ? o.full_max : p.full_max;
  p.kept_max = o.kept_max > p.kept_max ? o.kept_max : p.kept_max;
  p.n_keep += o.n_keep;
}

// A term's state over all of a doc's valid tokens -> its column max: Eq. 5
// takes the full max (floored when len < cap); Eq. 6 (use_filter) the kept
// max when some token was kept (floored when fewer than cap were), else
// falls back to Eq. 5; a masked term is 0.0.
__device__ __forceinline__ float eq56_finish(const Eq56Part& p, int len,
                                             int cap, int use_filter,
                                             bool live) {
  float colmax = p.full_max;
  if (len < cap) colmax = colmax > NEG ? colmax : NEG;
  if (use_filter && p.n_keep > 0)
    colmax = p.n_keep < cap ? (p.kept_max > NEG ? p.kept_max : NEG)
                            : p.kept_max;
  return live ? colmax : 0.0f;
}

// Eq. 5/6 score of one document by a block of SPLIT warps: the body of
// pqinter.cu's Eq. 5/6 pass and of pqscore.cu, which differ only in how a
// block finds its row. Block (r, b) scores row b * nf + sel2[b * n_docs +
// r] of codes (B, nf, cap) when sel2 is not null (pqinter: the phase-3
// winners), else row b * nf + r, and writes out[b * n_docs + r]. Warp w
// takes tokens w, w + SPLIT, ..., lane i = query term i; the warps' states
// merge through shared memory, and warp 0 finishes and term-sums. cs_t
// (B, n_c, n_q) of T; lut2 (B, m*ksub, n_q); res (B, nf, cap, m); qmask
// (B, n_q) or null; M as in eq56_full; th_r the value the reference
// compares a T centroid score with. Every thread of the block must call it.
template <int M, int SPLIT, typename T>
__device__ __forceinline__ void eq56_block(
    const T* __restrict__ cs_t, const float* __restrict__ lut2,
    const int32_t* __restrict__ codes, const uint8_t* __restrict__ res,
    const int32_t* __restrict__ lens, const uint8_t* __restrict__ qmask,
    const int32_t* __restrict__ sel2, int nf, int n_docs, int cap, int n_c,
    int n_q, int m, int ksub, float th_r, int use_filter,
    float* __restrict__ out) {
  __shared__ Eq56Part part[SPLIT][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x, b = blockIdx.y;
  const size_t row =
      (size_t)b * nf + (sel2 != nullptr ? sel2[(size_t)b * n_docs + r] : r);
  const int len = min(max(lens[row], 0), cap);
  Eq56Part acc = eq56_start();
  if (lane < n_q) {
    const int32_t* cd = codes + row * cap;
    const uint8_t* rs = res + row * cap * m;
    const T* cb = cs_t + (size_t)b * n_c * n_q + lane;
    const float* lb = lut2 + (size_t)b * m * ksub * n_q + lane;
#pragma unroll 2
    for (int t = warp; t < len; t += SPLIT) {
      const int c = min(max(cd[t], 0), n_c - 1);
      const float cen = Cs<T>::widen(cb[(size_t)c * n_q]);
      eq56_token(acc, cen,
                 eq56_full<M>(cen, lb, rs + (size_t)t * m, m, ksub, n_q),
                 th_r, use_filter);
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
  for (int k = 1; k < SPLIT; ++k) eq56_merge(acc, part[k][lane]);
  const uint8_t* qm = mask_row(qmask, b, n_q);
  const bool live = lane < n_q && (qm == nullptr || qm[lane]);
  const float s =
      term_sum_lanes(eq56_finish(acc, len, cap, use_filter, live), n_q);
  if (lane == 0) out[(size_t)b * n_docs + r] = s;
}

// Whether eq56_block<16> may run: m = 16 and the residual codes 16-byte
// aligned (each token's 16 codes are one vector load).
inline bool eq56_vector_m16(int m, const uint8_t* res) {
  return m == 16 && reinterpret_cast<uintptr_t>(res) % 16 == 0;
}

}  // namespace emvb
