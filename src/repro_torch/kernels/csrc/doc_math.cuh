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
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace emvb {

constexpr float NEG = -1e9f;   // an invalid token's score in every max

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
// points at cs[0, c]; term rows are `stride` floats apart.
__device__ __forceinline__ uint32_t pack_column(const float* __restrict__ col,
                                                size_t stride, float th,
                                                uint32_t live, int n_q) {
  uint32_t w = 0;
  for (int i = 0; i < n_q; ++i)
    if (col[(size_t)i * stride] > th) w |= 1u << i;
  return w & live;
}

// Four neighbouring columns at once (col 16-byte aligned, stride a multiple
// of 4): the same bits as four pack_column calls, with one 16-byte load per
// term.
__device__ __forceinline__ uint4 pack_columns4(const float* __restrict__ col,
                                               size_t stride, float th,
                                               uint32_t live, int n_q) {
  uint4 w = make_uint4(0, 0, 0, 0);
#pragma unroll 8
  for (int i = 0; i < n_q; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(col + (size_t)i * stride);
    w.x |= (uint32_t)(v.x > th) << i;
    w.y |= (uint32_t)(v.y > th) << i;
    w.z |= (uint32_t)(v.z > th) << i;
    w.w |= (uint32_t)(v.w > th) << i;
  }
  w.x &= live;
  w.y &= live;
  w.z &= live;
  w.w &= live;
  return w;
}

// --- Eq. 4: a document's word OR ------------------------------------------------

// The transposed word table the dense form reads: bits (B, n_c) -> bitsT
// (n_c, B). One block of 256 threads per 32 columns, through shared
// memory, so the reads of bits are whole 128-byte lines and the writes of
// bitsT whole rows.
__device__ __forceinline__ void transpose_words(const uint32_t* __restrict__ bits,
                                                int B, int n_c,
                                                uint32_t* __restrict__ bitsT) {
  __shared__ uint32_t t[32][33];
  const int c0 = blockIdx.x * 32, x = threadIdx.x & 31, y = threadIdx.x >> 5;
  for (int b = y; b < B; b += blockDim.x >> 5)
    if (c0 + x < n_c) t[b][x] = bits[(size_t)b * n_c + c0 + x];
  __syncthreads();
  for (int j = y; j < 32; j += blockDim.x >> 5)
    if (c0 + j < n_c && x < B) bitsT[(size_t)(c0 + j) * B + x] = t[x][j];
}

// Dense form, every query at once (bitfilter.cu, and the fused prefilter's
// docs with many candidate queries): a warp's lanes split into (token group
// g, query bq) pairs, Q lanes per group (Q >= B, a power of two) and G =
// 32 / Q groups: lane (g, bq) ORs query bq's words of tokens g, g + G, ...
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

// --- term_sum -------------------------------------------------------------------

// term_sum over a warp holding one term per lane: lane 0 + lane 1 + ... +
// lane n_q-1, in that order (a shuffle tree would change bits). All 32 lanes
// must call it; every lane gets the sum.
__device__ __forceinline__ float term_sum_lanes(float colmax, int n_q) {
  float s = __shfl_sync(FULL_MASK, colmax, 0);
  for (int i = 1; i < n_q; ++i) s = s + __shfl_sync(FULL_MASK, colmax, i);
  return s;
}

// --- S̄ (Eq. 2) ------------------------------------------------------------------

// A per-term max over tokens, started at -INFINITY: one token's CS^T value,
// or another warp's partial max.
__device__ __forceinline__ float sbar_token(float acc, float v) {
  return v > acc ? v : acc;
}

// The per-term max over all of a doc's valid tokens -> the term's column
// max: the -1e9 floor when the doc has invalid tokens, 0.0 for a masked
// term.
__device__ __forceinline__ float sbar_finish(float acc, int len, int cap,
                                             bool live) {
  if (len < cap) acc = acc > NEG ? acc : NEG;
  return live ? acc : 0.0f;
}

// S̄ of one document in one warp, lane i = query term i, tokens in series
// (cinter.cu). cb = this query's (n_c, n_q) CS^T; cd = the doc's codes; qm =
// the query's term mask or null. All 32 lanes must call it.
__device__ __forceinline__ float sbar_doc(const float* __restrict__ cb,
                                          const int32_t* __restrict__ cd,
                                          int len, const uint8_t* __restrict__ qm,
                                          int cap, int n_c, int n_q, int lane) {
  len = min(max(len, 0), cap);
  float acc = -INFINITY;
  if (lane < n_q) {
    for (int t = 0; t < len; ++t) {
      const int c = min(max(cd[t], 0), n_c - 1);
      acc = sbar_token(acc, cb[(size_t)c * n_q + lane]);
    }
  }
  const bool live = lane < n_q && (qm == nullptr || qm[lane]);
  return term_sum_lanes(sbar_finish(acc, len, cap, live), n_q);
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

// Eq. 5/6 score of one document in one warp, lane i = query term i, tokens
// in series (pqscore.cu). cb = this query's (n_c, n_q) CS^T; lb = its
// (m*ksub, n_q) flattened LUT; rs = the doc's (cap, m) residual codes; qm =
// the query's term mask or null. All 32 lanes must call it.
__device__ __forceinline__ float eq56_doc(
    const float* __restrict__ cb, const float* __restrict__ lb,
    const int32_t* __restrict__ cd, const uint8_t* __restrict__ rs, int len,
    const uint8_t* __restrict__ qm, int cap, int n_c, int n_q, int m,
    int ksub, float th_r, int use_filter, int lane) {
  len = min(max(len, 0), cap);
  Eq56Part p = eq56_start();
  if (lane < n_q) {
    for (int t = 0; t < len; ++t) {
      const int c = min(max(cd[t], 0), n_c - 1);
      const float cen = cb[(size_t)c * n_q + lane];
      eq56_token(p, cen, eq56_full<0>(cen, lb + lane, rs + (size_t)t * m, m,
                                      ksub, n_q),
                 th_r, use_filter);
    }
  }
  const bool live = lane < n_q && (qm == nullptr || qm[lane]);
  return term_sum_lanes(eq56_finish(p, len, cap, use_filter, live), n_q);
}

}  // namespace emvb
