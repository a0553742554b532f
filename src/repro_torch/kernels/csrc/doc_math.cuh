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

#include <cooperative_groups.h>
#include <mutex>
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
//
// The Eq. 5/6 pass scores a doc's valid tokens against each query term: the
// centroid score from CS^T plus the residual lut[s=0] + ... + lut[s=m-1],
// each a read of the query's (n_q, m, K) LUT at the token's residual code of
// subspace s (512 KiB a query at n_q 32, m 16, K 256). Per (doc, token,
// term) that is m + 1 reads, so what bounds the pass on the H100 is where
// those reads are served, not the card's memory: a doc's codes and residual
// codes are ~1.6 KB, the LUT and CS^T rows its ~67 tokens read ~146 KB.
//
// Two forms, chosen on the host from the shape (eq56_plan):
//  * the cluster pass (eq56_cluster), wherever one term's LUT slice fits a
//    CTA's shared memory (m * K up to ~54,000). The flattened LUT is
//    term-group-major, (B, G, rows, T) (pqinter.py's flat_lut): T terms a
//    group (8 while m * K * 32 bytes fits beside the pass's 16 KB of merge
//    buffers, as at emvb-msmarco and MIND, else 4, 2 or 1), G = ceil(n_q /
//    T), each group's slice one contiguous block. A thread-block cluster of
//    C = min(G, 8) CTAs scores runs of one query's docs; CTA r holds the
//    slice of group r (and r + C, ... in turn when G > 8) in shared memory,
//    staged by bulk copies on an mbarrier. A warp scores one doc at a time
//    with lanes (token slot, term quad): 16 tokens a warp load at T = 8,
//    each lane reading 4 terms of a LUT row in one 16-byte shared-memory
//    read, its m reads issued before the first add and added in the
//    reference's order s = 0 .. m-1, then the widened centroid scores from
//    CS^T (one 16-byte global read a token and lane where rows allow). The
//    doc's codes and residual codes are read from global memory one warp
//    load ahead of the LUT reads that need them, with the next CS^T
//    entries. Per term, the token slots' Eq56Part states merge by shuffles
//    (order-free); each CTA finishes its terms (eq56_finish) into its
//    shared memory, and after a cluster barrier every CTA term-sums a share
//    of the docs, reading each group's column maxima through distributed
//    shared memory, in lane order: one float a doc. What bounds it then is
//    the SM's issue of those reads and adds and its shared-memory
//    wavefronts: a 16-byte read by 8 lanes (4 tokens) hits bank group
//    code mod 4 of each token, so random codes cost about two wavefronts a
//    quarter warp.
//  * the L2 form (eq56_block), kept for larger slices: one block a doc, one
//    lane a term, every LUT read a 128-byte row gathered through L2, which
//    bounds it at L2's line rate (~6.6 TB/s of rows on the H100, PERF.md).
// A ring of doc slots filled by bulk copies (multicast to the cluster, or
// per CTA) or by cp.async was measured no faster than the direct reads, so
// the pass has none.
//
// Both forms compute what the reference's eq56_block and
// eq56_block_batched compute (repro/kernels/pqscore.py:33, :74), to the bit.

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
// lane's term in row 0 of the query's LUT, whose rows are `stride` floats
// apart; rt at the token's m residual codes. M = m known at compile time (a
// multiple of 16): the codes arrive in vector loads and all m LUT reads are
// issued before the first add. M = 0: any m, read in series.
template <int M>
__device__ __forceinline__ float eq56_full(float cen,
                                           const float* __restrict__ lb,
                                           const uint8_t* __restrict__ rt,
                                           int m, int ksub, int stride) {
  float resid;
  if constexpr (M == 0) {
    resid = lb[(size_t)rt[0] * stride];
    for (int s = 1; s < m; ++s)
      resid = resid + lb[((size_t)s * ksub + rt[s]) * stride];
  } else {
    uint32_t w[M / 4];
    load_code_words<M>(rt, w);
    float v[M];
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const uint32_t code = (w[s >> 2] >> (8 * (s & 3))) & 0xffu;
      v[s] = lb[((size_t)s * ksub + code) * stride];
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

// Merge another part's state of the same term and doc into p.
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

// The L2 form: Eq. 5/6 score of one document by a block of SPLIT warps.
// Block (r, b) scores row b * nf + sel2[b * n_docs + r] of codes (B, nf,
// cap) when sel2 is not null (pqinter: the phase-3 winners), else row b * nf
// + r, and writes out[b * n_docs + r]. Warp w takes tokens w, w + SPLIT,
// ..., lane i = query term i; the warps' states merge through shared
// memory, and warp 0 finishes and term-sums. cs_t (B, n_c, n_q) of T; lut2
// the (B, 1, rows, n_q) LUT of flat_lut with one group of n_q terms; res
// (B, nf, cap, m); qmask (B, n_q) or null; M as in eq56_full; th_r the value
// the reference compares a T centroid score with. Every thread of the block
// must call it.
template <int M, int SPLIT, typename T>
__device__ __forceinline__ void eq56_block(
    const T* __restrict__ cs_t, const float* __restrict__ lut2,
    const int32_t* __restrict__ codes, const uint8_t* __restrict__ res,
    const int32_t* __restrict__ lens, const uint8_t* __restrict__ qmask,
    const int32_t* __restrict__ sel2, int nf, int n_docs, int cap, int n_c,
    int n_q, int m, int ksub, int rows, float th_r, int use_filter,
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
    const float* lb = lut2 + (size_t)b * rows * n_q + lane;
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

// Whether the m = 16 vector form may run: m = 16 and the residual codes
// 16-byte aligned (each token's 16 codes are one vector load).
inline bool eq56_vector_m16(int m, const uint8_t* res) {
  return m == 16 && reinterpret_cast<uintptr_t>(res) % 16 == 0;
}

// --- Eq. 5/6, the cluster pass ---------------------------------------------------

constexpr int E56_WARPS = 16;          // warps a CTA, each a doc at a time
constexpr int E56_THREADS = E56_WARPS * 32;
constexpr int E56_ITEM = 256;          // docs merged at one cluster barrier
constexpr int E56_TERMS_MAX = 8;       // T, at most
constexpr int E56_CLUSTER_MAX = 8;     // C: the portable cluster size
constexpr int E56_CHUNK = 1 << 15;     // bytes a bulk copy of the slice
// column maxima a CTA keeps: two items (one being merged while the next is
// scored) of T * passes <= 8 terms a doc
constexpr int E56_MERGE_BYTES = 2 * E56_ITEM * E56_TERMS_MAX * 4;
constexpr int E56_BAR_BYTES = 16;      // the slice's mbarrier
constexpr int E56_RESERVED = E56_MERGE_BYTES + E56_BAR_BYTES;
// The schedule's cost model (eq56_runs), in units of the time a full SM
// takes for one doc's LUT reads at emvb-msmarco's shape.
constexpr int E56_STAGE_COST = 8;      // staging a query's slices
constexpr int E56_LONE_COST = 8;       // one doc on a warp that runs alone

// The cluster pass's operands and plan (eq56_plan), passed by value.
// Query b's rows are b * nf + row; row = sel2[b * n_docs + d] (pqinter:
// the phase-3 winners, -1 a filler that scores -inf and reads nothing) or
// d (sel2 null, pqscore); out (B, n_docs).
template <typename T>
struct Eq56Args {
  const T* cs_t;          // (B, n_c, n_q)
  const float* lut;       // (B, groups, rows, terms)
  const int32_t* codes;   // (B, nf, cap)
  const uint8_t* res;     // (B, nf, cap, m)
  const int32_t* lens;    // (B, nf)
  const uint8_t* qmask;   // (B, n_q) or null
  const int32_t* sel2;    // (B, n_docs) or null
  float* out;             // (B, n_docs)
  int nb, nf, n_docs, cap, n_c, n_q, m, ksub;
  float th_r;
  int use_filter;
  int terms, groups, passes, rows, runs;
};

// Rows of a group's slice: m * K, padded so that a slice is a whole number
// of 16-byte pieces (rows * terms a multiple of 4).
__host__ __device__ inline int e56_rows(int mk, int terms) {
  const int q = terms >= 4 ? 1 : 4 / terms;
  return (mk + q - 1) / q * q;
}

// Run r = run % runs of query b = run / runs: the query's docs r, r +
// runs, r + 2 * runs, ..., its positions 0 .. *count - 1. Dealt in turns,
// a run's docs spread over the query's ranks, so pqinter's fillers (the
// last ranks when few survivors pass doc_pass) fall on every run alike.
__device__ __forceinline__ void e56_run(int run, int runs, int n_docs, int* b,
                                        int* r, int* count) {
  *b = run / runs;
  *r = run % runs;
  *count = *r < n_docs ? (n_docs - *r + runs - 1) / runs : 0;
}

__device__ __forceinline__ int e56_row(const int32_t* __restrict__ sel2,
                                       int b, int n_docs, int d) {
  return sel2 == nullptr ? d : sel2[(size_t)b * n_docs + d];
}

// Four CS^T entries at p (16-byte aligned in float32, 8 in bf16), widened:
// one global load.
__device__ __forceinline__ void cs_load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
__device__ __forceinline__ void cs_load4(const __nv_bfloat16* p,
                                         float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

// V floats of the staged slice at p (4 * V-byte aligned): one
// shared-memory load of 4, 8 or 16 bytes.
template <int V>
__device__ __forceinline__ void lut_load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = *p;
  }
}

// The lane mapping of a group of TT terms: V = min(TT, 4) terms a lane
// (one 4-, 8- or 16-byte LUT read), TT / V lanes a token, SL token slots
// a warp load.
template <int TT>
struct E56Lanes {
  static constexpr int V = TT < 4 ? TT : 4;
  static constexpr int L = TT / V;
  static constexpr int SL = 32 / L;
};

// One doc's Eq. 5/6 states for the lane's V terms: lane (slot, quad) takes
// tokens slot, slot + SL, ... and terms quad * V .. quad * V + V - 1 of
// its CTA's group. cs_row points at the lane's first term in row 0 of the
// query's CS^T; lut_q at the lane's first term in row 0 of the staged
// slice; cd, rs the doc's codes and residual codes; bit v of lv: term v is
// live (its state is computed). Per (token, subspace) one shared-memory
// read of V terms; a token's m reads are issued before the first add, each
// term's adds run s = 0 .. m-1. The next warp load's codes, CS^T entries
// and residual code words are read before this one's LUT reads. All 32
// lanes call it; the token slots' states are merged on return.
template <int M, int TT, typename T>
__device__ __forceinline__ void eq56_lane_tokens(
    Eq56Part (&acc)[E56Lanes<TT>::V], const T* __restrict__ cs_row,
    const float* lut_q, const int32_t* __restrict__ cd,
    const uint8_t* __restrict__ rs, int len, int n_c, int n_q, int m,
    int ksub, int slot, unsigned lv, bool cs_vec, float th_r,
    int use_filter) {
  constexpr int V = E56Lanes<TT>::V, SL = E56Lanes<TT>::SL;
  constexpr int W = M > 0 ? M / 4 : 1;
  auto centroid = [&](int t, float (&cen)[V]) {
    const int c = min(max(cd[t], 0), n_c - 1);
    if constexpr (V == 4) {
      if (cs_vec) {
        cs_load4(cs_row + (size_t)c * n_q, cen);
        return;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      cen[v] = (lv >> v) & 1u ? Cs<T>::widen(cs_row[(size_t)c * n_q + v])
                              : 0.0f;
  };
  auto words = [&](int t, uint32_t (&w)[W]) {
    if constexpr (M > 0) load_code_words<M>(rs + (size_t)t * M, w);
  };
  const int stride = ksub * TT;          // floats between subspaces
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = eq56_start();
  float cen_next[V];
  uint32_t w_next[W];
  if (slot < len) {
    centroid(slot, cen_next);
    words(slot, w_next);
  }
  for (int t = slot; t < len; t += SL) {
    float cen[V];
    uint32_t w[W];
#pragma unroll
    for (int v = 0; v < V; ++v) cen[v] = cen_next[v];
#pragma unroll
    for (int k = 0; k < W; ++k) w[k] = w_next[k];
    if (t + SL < len) {
      centroid(t + SL, cen_next);
      words(t + SL, w_next);
    }
    float resid[V];
    if constexpr (M == 0) {
      const uint8_t* rt = rs + (size_t)t * m;
      lut_load<V>(lut_q + rt[0] * TT, resid);
      for (int s = 1; s < m; ++s) {
        float x[V];
        lut_load<V>(lut_q + s * stride + rt[s] * TT, x);
#pragma unroll
        for (int v = 0; v < V; ++v) resid[v] = resid[v] + x[v];
      }
    } else {
      float x[M][V];
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const int code = (w[s >> 2] >> (8 * (s & 3))) & 0xff;
        lut_load<V>(lut_q + s * stride + code * TT, x[s]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        resid[v] = x[0][v];
#pragma unroll
        for (int s = 1; s < M; ++s) resid[v] = resid[v] + x[s][v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if ((lv >> v) & 1u)
        eq56_token(acc[v], cen[v], cen[v] + resid[v], th_r, use_filter);
  }
  // merge the token slots: a term's lanes are L apart
#pragma unroll
  for (int o = E56Lanes<TT>::L; o < 32; o <<= 1)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      Eq56Part x;
      x.full_max = __shfl_xor_sync(FULL_MASK, acc[v].full_max, o);
      x.kept_max = __shfl_xor_sync(FULL_MASK, acc[v].kept_max, o);
      x.n_keep = __shfl_xor_sync(FULL_MASK, acc[v].n_keep, o);
      eq56_merge(acc[v], x);
    }
}

// A warp's docs of an item of run r for its CTA's group g (TT terms): the
// docs at run positions ilo + warp, + E56_WARPS, ... below ihi (doc r +
// runs * position), each doc's column maxima finished (eq56_finish) into
// col_base + (position - ilo) * TP by the lanes of slot 0; fillers
// skipped. Each doc's row and length are read for all of the
// warp's docs at once, a lane each, before the wait for a slice being
// staged (`staging`, parity `phase`; null: none). All 32 lanes call it.
template <int M, int TT, typename T>
__device__ __forceinline__ void eq56_warp_docs(const Eq56Args<T>& a,
                                               const float* lut_s,
                                               float* col_base, int TP, int b,
                                               int g, int r, int ilo,
                                               int ihi,
                                               uint64_t* staging,
                                               unsigned phase) {
  using Ln = E56Lanes<TT>;
  constexpr int V = Ln::V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / Ln::L, quad = lane % Ln::L;
  const int t0 = g * TT + quad * V;          // the lane's first term
  const uint8_t* qm = mask_row(a.qmask, b, a.n_q);
  unsigned lv = 0;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (t0 + v < a.n_q && (qm == nullptr || qm[t0 + v])) lv |= 1u << v;
  // one load of the lane's 4 CS^T entries when the row holds them aligned
  const bool cs_vec =
      a.n_q % 4 == 0 &&
      reinterpret_cast<uintptr_t>(a.cs_t) % (4 * sizeof(T)) == 0;
  const T* cs_row = a.cs_t + (size_t)b * a.n_c * a.n_q + (lv ? t0 : 0);
  int my_row = -1, my_len = 0;
  const int pl = ilo + warp + E56_WARPS * lane;
  if (lane < E56_ITEM / E56_WARPS && pl < ihi) {
    my_row = e56_row(a.sel2, b, a.n_docs, r + a.runs * pl);
    if (my_row >= 0)
      my_len = min(max(a.lens[(size_t)b * a.nf + my_row], 0), a.cap);
  }
  if (staging != nullptr) mbar_wait(staging, phase);
  for (int i = 0; i < E56_ITEM / E56_WARPS; ++i) {       // warp-uniform
    const int pos = ilo + warp + E56_WARPS * i;
    if (pos >= ihi) break;
    const int row = __shfl_sync(FULL_MASK, my_row, i);
    const int len = __shfl_sync(FULL_MASK, my_len, i);
    if (row < 0) continue;
    const size_t rw = (size_t)b * a.nf + row;
    Eq56Part acc[V];
    eq56_lane_tokens<M, TT, T>(acc, cs_row, lut_s + quad * V,
                               a.codes + rw * a.cap, a.res + rw * a.cap * a.m,
                               lv ? len : 0, a.n_c, a.n_q, a.m, a.ksub, slot,
                               lv, cs_vec, a.th_r, a.use_filter);
    if (slot == 0) {
      float* col = col_base + (pos - ilo) * TP + quad * V;
#pragma unroll
      for (int v = 0; v < V; ++v)
        col[v] = eq56_finish(acc[v], len, a.cap, a.use_filter, (lv >> v) & 1u);
    }
  }
}

// The cluster pass's body (see the section note): the eq56_kernel of
// pqinter.cu and the pqscore_kernel of pqscore.cu, launched by eq56_launch
// with eq56_plan's grid, cluster and shared memory. The clusters are
// persistent: cluster cid takes runs cid, cid + ncl, ... (eq56_runs), each
// cut into items of E56_ITEM docs; an item is scored once per group a CTA
// holds, then merged. Every thread of every CTA of the cluster must call
// it.
template <int M, typename T>
__device__ __forceinline__ void eq56_cluster(const Eq56Args<T>& a) {
  extern __shared__ __align__(128) unsigned char e56_smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int n_runs = a.runs * a.nb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int TT = a.terms;
  const int TP = TT * a.passes;                   // column maxima a doc
  // shared memory: the slice | two items' column maxima | its mbarrier
  const size_t slice_bytes = (size_t)a.rows * TT * 4;
  float* lut_s = reinterpret_cast<float*>(e56_smem);
  float* merge = reinterpret_cast<float*>(e56_smem + slice_bytes);
  uint64_t* slice_bar =
      reinterpret_cast<uint64_t*>(e56_smem + slice_bytes + E56_MERGE_BYTES);
  if (threadIdx.x == 0) {
    mbar_init(slice_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  int staged_b = -1, staged_g = -1, stagings = 0, items = 0;
  for (int run = cid; run < n_runs; run += ncl) {
    int b, r, count;
    e56_run(run, a.runs, a.n_docs, &b, &r, &count);
    for (int ilo = 0; ilo < count; ilo += E56_ITEM) {
      const int ihi = min(count, ilo + E56_ITEM);
      float* mbuf = merge + (size_t)(items & 1) * E56_ITEM * TP;
      for (int p = 0; p < a.passes; ++p) {
        const int g = rank + p * C;
        if (g >= a.groups) continue;                   // block-uniform
        uint64_t* staging = nullptr;      // a slice to wait for
        if (b != staged_b || g != staged_g) {
          __syncthreads();            // every warp is done with the slice
          if (threadIdx.x == 0) {
            fence_proxy_async();
            mbar_expect_tx(slice_bar, (unsigned)slice_bytes);
            const char* src = reinterpret_cast<const char*>(
                a.lut + ((size_t)b * a.groups + g) * a.rows * TT);
            for (size_t off = 0; off < slice_bytes; off += E56_CHUNK)
              bulk_load(e56_smem + off, src + off,
                        slice_bytes - off < E56_CHUNK
                            ? (unsigned)(slice_bytes - off)
                            : (unsigned)E56_CHUNK,
                        slice_bar);
          }
          staging = slice_bar;
          ++stagings;
          staged_b = b;
          staged_g = g;
        }
        float* col = mbuf + p * TT;
        const unsigned phase = (stagings - 1) & 1;
        switch (TT) {
          case 8:
            eq56_warp_docs<M, 8>(a, lut_s, col, TP, b, g, r, ilo, ihi,
                                 staging, phase);
            break;
          case 4:
            eq56_warp_docs<M, 4>(a, lut_s, col, TP, b, g, r, ilo, ihi,
                                 staging, phase);
            break;
          case 2:
            eq56_warp_docs<M, 2>(a, lut_s, col, TP, b, g, r, ilo, ihi,
                                 staging, phase);
            break;
          default:
            eq56_warp_docs<M, 1>(a, lut_s, col, TP, b, g, r, ilo, ihi,
                                 staging, phase);
        }
      }
      cluster.sync();               // every CTA's column maxima are in
      // each CTA term-sums every C-th doc, lane i = term i from the CTA
      // holding its group (distributed shared memory), in lane order
      for (int j = rank * E56_WARPS + warp; j < ihi - ilo;
           j += C * E56_WARPS) {                             // warp-uniform
        const int d = r + a.runs * (ilo + j);
        const int row = e56_row(a.sel2, b, a.n_docs, d);
        float v = 0.0f;
        if (row >= 0 && lane < a.n_q) {
          const int g = lane / TT;
          const float* src = cluster.map_shared_rank(mbuf, g % C);
          v = src[j * TP + (g / C) * TT + lane % TT];
        }
        const float sum = term_sum_lanes(v, a.n_q);
        if (lane == 0)
          a.out[(size_t)b * a.n_docs + d] = row < 0 ? -INFINITY : sum;
      }
      ++items;
    }
  }
  cluster.sync();   // no CTA leaves while another reads its column maxima
}

// How the cluster pass runs a launch: its form, the slice and the
// schedule. (For the L2 form only `cluster_form` = 0 and `terms` = n_q,
// the LUT's one group, are set.)
struct Eq56Plan {
  int cluster_form;   // 1: eq56_cluster; 0: the L2 form (eq56_block)
  int terms;          // T: terms a group (the LUT's last dimension)
  int groups;         // G = ceil(n_q / T)
  int cluster;        // C = min(G, E56_CLUSTER_MAX) CTAs a cluster
  int passes;         // ceil(G / C): groups a CTA holds in turn
  int rows;           // rows of a slice
  int runs;           // runs a query: a query's docs over that many clusters
  int clusters;       // clusters launched (persistent, at most one wave)
  int smem;           // dynamic shared bytes a CTA
  long long staged_bytes;   // LUT bytes all CTAs stage in the launch
};

// The current card's opt-in shared memory a block, read once a device.
inline int e56_smem_max() {
  static int cached[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && cached[dev] > 0) return cached[dev];
  int v = 232448;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev < 16) cached[dev] = v;
  return v;
}

// T for a query of n_q terms over m subspaces of ksub centroids: the most
// terms (a power of two up to E56_TERMS_MAX, no more than n_q needs) whose
// slice fits a CTA's shared memory beside the merge buffers; 0 when not even
// one term's does (the L2 form).
inline int eq56_terms(int n_q, int m, int ksub) {
  const int smax = e56_smem_max();
  for (int t = min(E56_TERMS_MAX, next_pow2(n_q)); t >= 1; t >>= 1)
    if ((long long)e56_rows(m * ksub, t) * t * 4 + E56_RESERVED <= smax)
      return t;
  return 0;
}

// Clusters of `cluster` CTAs of `kernel` that fit the card at once, each CTA
// with `smem` dynamic shared bytes; the kernel's shared-memory limit raised
// on first use. Cached per (kernel, device, cluster, smem).
inline int e56_slots(const void* kernel, int cluster, int smem) {
  struct Entry {
    const void* kernel;
    int dev, cluster, smem, slots;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev &&
        cache[i].cluster == cluster && cache[i].smem == smem)
      return cache[i].slots;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           e56_smem_max()) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * E56_CLUSTER_MAX, 1, 1);
  cfg.blockDim = dim3(E56_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) n = 0;
  if (n > 0 && used < 64) cache[used++] = {kernel, dev, cluster, smem, n};
  return n;
}

// Runs a query (the schedule): the query's docs are dealt to `runs` runs
// in turns (e56_run), a cluster each, and the clusters, at most S at once
// (one wave; 30 clusters of 4 on the H100), take the B * runs runs in
// query-major turns, so that the clusters at work at one time share one or
// two queries' CS^T in L2 (32 MB a query at emvb-msmarco's shape). The rule picks the runs,
// 1 .. min(n_docs, S), that minimise the modelled time of the busiest
// cluster: ceil(B * runs / S) runs, each costing its docs (a full SM's time
// a doc), or E56_LONE_COST a doc a warp when it has fewer docs than warps,
// plus a staging of its query's slices (E56_STAGE_COST). On the H100 it
// gives 6 runs of 43 docs a query at B = 32 and 256 docs, 29 runs of 9
// docs at B = 1, and 15 runs of 667 docs at fig9's 10,000 docs and
// B = 32. Measured (scripts/chip_eq56_pass.py's sweep of pqscore's runs a
// query, device ms, NVIDIA H100 80GB HBM3, 700 W), the rule's choice is
// within 3 % of the best of 1, 2, 4, 8, 16, 32, 64 at B = 32 and 1, under
// the default config and fig9's: at B = 32 and 256 docs 1 run takes 0.237,
// 4 0.167, 6 0.167, 8 0.163, 32 0.285; at B = 1, 16 runs 0.0121, 29 0.0099,
// 32 0.0160; at fig9 and B = 32 1 run 8.82, 4 5.51, 15 4.71, 64 4.85.
inline int eq56_runs(int B, int n_docs, int S) {
  int best = 1;
  long long best_cost = -1;
  for (int r = 1; r <= min(n_docs, S); ++r) {
    const long long turns = ((long long)B * r + S - 1) / S;
    const long long docs = (n_docs + r - 1) / r;
    const long long lone =
        E56_LONE_COST * ((docs + E56_WARPS - 1) / E56_WARPS);
    const long long cost =
        turns * ((docs > lone ? docs : lone) + E56_STAGE_COST);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = r;
    }
  }
  return best;
}

// The plan of one launch of `kernel` (an instantiation of a kernel running
// eq56_cluster) over B queries of n_docs docs; runs > 0 overrides the
// schedule's runs a query (chip measurements of the rule). Fails when no
// cluster of the plan fits the card.
inline cudaError_t eq56_plan(const void* kernel, int B, int n_docs, int n_q,
                             int m, int ksub, int runs, Eq56Plan* p) {
  *p = Eq56Plan{};
  p->terms = eq56_terms(n_q, m, ksub);
  if (p->terms == 0) {
    p->terms = n_q;
    return cudaSuccess;
  }
  p->cluster_form = 1;
  p->groups = (n_q + p->terms - 1) / p->terms;
  p->cluster = min(p->groups, E56_CLUSTER_MAX);
  p->passes = (p->groups + p->cluster - 1) / p->cluster;
  p->rows = e56_rows(m * ksub, p->terms);
  const long long slice = (long long)p->rows * p->terms * 4;
  p->smem = (int)(slice + E56_RESERVED);
  const int S = e56_slots(kernel, p->cluster, p->smem);
  if (S <= 0) return cudaErrorInvalidConfiguration;
  p->runs = runs > 0 ? min(runs, n_docs) : eq56_runs(B, n_docs, S);
  const int n_runs = B * p->runs;
  p->clusters = min(S, n_runs);
  // the stagings: per cluster, once per query while a CTA holds one group,
  // else once per item and group
  long long st = 0;
  for (int c = 0; c < p->clusters; ++c) {
    int prev = -1;
    for (int run = c; run < n_runs; run += p->clusters) {
      const int b = run / p->runs, r = run % p->runs;
      const long long docs = (n_docs - r + p->runs - 1) / p->runs;
      if (p->passes == 1) {
        if (b != prev) st += p->cluster;
      } else {
        st += (docs + E56_ITEM - 1) / E56_ITEM * p->groups;
      }
      prev = b;
    }
  }
  p->staged_bytes = st * slice;
  return cudaSuccess;
}

// One launch of the cluster pass on plan p: clusters * C CTAs, a cluster
// of C, p.smem dynamic shared bytes.
template <typename T>
inline cudaError_t eq56_launch(void (*kernel)(const Eq56Args<T>),
                               const Eq56Plan& p, const Eq56Args<T>& args,
                               cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * p.cluster, 1, 1);
  cfg.blockDim = dim3(E56_THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// The Eq56Args of a launch on plan p.
template <typename T>
inline Eq56Args<T> eq56_args(const T* cs_t, const float* lut,
                             const int32_t* codes, const uint8_t* res,
                             const int32_t* lens, const uint8_t* qmask,
                             const int32_t* sel2, float* out, int B, int nf,
                             int n_docs, int cap, int n_c, int n_q, int m,
                             int ksub, float th_r, int use_filter,
                             const Eq56Plan& p) {
  return Eq56Args<T>{cs_t, lut, codes, res, lens, qmask, sel2, out,
                     B, nf, n_docs, cap, n_c, n_q, m, ksub, th_r, use_filter,
                     p.terms, p.groups, p.passes, p.rows, p.runs};
}

}  // namespace emvb
