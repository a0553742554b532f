// Per-column and per-document EMVB math shared by the fused kernels
// (prefilter.cu, pqinter.cu) and the unfused ones (bitpack.cu, bitfilter.cu,
// cinter.cu, pqscore.cu). The reference shares sbar_block between cinter.py
// and pqinter.py, and eq56_block between pqscore.py and pqinter.py, "in
// lockstep"; here both lanes call these functions, so they give the same
// bits by construction.
//
// Bit-exact rules kept here: float32 compares, no fast math, the residual
// starts from the s = 0 gather and adds s = 1..m-1 in order, term_sum is
// lane 0 + lane 1 + ... in serial shuffles, and a per-term max starts from
// the reference's -1e9 floor only when the doc has invalid tokens
// (len < cap), from -inf otherwise.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace emvb {

constexpr float NEG = -1e9f;   // an invalid token's score in every max

// Phase 1b, one centroid column: bit i = term i is live and cs[i, c] > th.
// `col` points at cs[0, c]; term rows are `stride` floats apart.
__device__ __forceinline__ uint32_t pack_column(const float* __restrict__ col,
                                                size_t stride, float th,
                                                const uint8_t* __restrict__ qm,
                                                int n_q) {
  uint32_t w = 0;
  for (int i = 0; i < n_q; ++i)
    if (qm[i] && col[(size_t)i * stride] > th) w |= 1u << i;
  return w;
}

// Eq. 4's OR over one document's first `len` tokens. A warp's lanes split
// into (token group g, query bq) pairs, Q lanes per group (Q >= B, a power
// of two) and G = 32 / Q groups: lane (g, bq) ORs query bq's words of
// tokens g, g + G, ... from the transposed (n_c, B) word table, and the
// shuffles fold the groups, so each lane of query bq ends with the doc's
// word. Lanes with `active` false gather nothing but join the shuffles; all
// 32 lanes must call it.
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
  for (int o = Q; o < 32; o <<= 1) acc |= __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// term_sum over a warp holding one term per lane: lane 0 + lane 1 + ... +
// lane n_q-1, in that order (a shuffle tree would change bits). All 32 lanes
// must call it; every lane gets the sum.
__device__ __forceinline__ float term_sum_lanes(float colmax, int n_q) {
  float s = __shfl_sync(0xffffffffu, colmax, 0);
  for (int i = 1; i < n_q; ++i) s = s + __shfl_sync(0xffffffffu, colmax, i);
  return s;
}

// S̄ (Eq. 2) of one document, lane i = query term i: per live term the max
// over valid tokens of cs_t[code, i], masked terms 0.0, then term_sum.
// cb = this query's (n_c, n_q) CS^T; cd = the doc's codes; qm = the query's
// term mask. All 32 lanes must call it.
__device__ __forceinline__ float sbar_doc(const float* __restrict__ cb,
                                          const int32_t* __restrict__ cd,
                                          int len, const uint8_t* __restrict__ qm,
                                          int cap, int n_c, int n_q, int lane) {
  len = min(max(len, 0), cap);
  float acc = len < cap ? NEG : -INFINITY;
  if (lane < n_q) {
    for (int t = 0; t < len; ++t) {
      const int c = min(max(cd[t], 0), n_c - 1);
      const float v = cb[(size_t)c * n_q + lane];
      acc = v > acc ? v : acc;
    }
  }
  const float colmax = lane < n_q && qm[lane] ? acc : 0.0f;
  return term_sum_lanes(colmax, n_q);
}

// Eq. 5/6 score of one document, lane i = query term i: per (token, term)
// the centroid score plus the residual lut[s=0] + ... + lut[s=m-1]; Eq. 5
// takes the max over valid tokens, Eq. 6 (use_filter) the max over tokens
// whose centroid score beats th_r, falling back to the full max when none
// does; masked terms 0.0; then term_sum. lb = this query's (m*ksub, n_q)
// flattened LUT; rs = the doc's (cap, m) residual codes. All 32 lanes must
// call it.
__device__ __forceinline__ float eq56_doc(
    const float* __restrict__ cb, const float* __restrict__ lb,
    const int32_t* __restrict__ cd, const uint8_t* __restrict__ rs, int len,
    const uint8_t* __restrict__ qm, int cap, int n_c, int n_q, int m,
    int ksub, float th_r, int use_filter, int lane) {
  len = min(max(len, 0), cap);
  float full_max = len < cap ? NEG : -INFINITY;
  float kept_max = -INFINITY;
  int n_keep = 0;
  if (lane < n_q) {
    for (int t = 0; t < len; ++t) {
      const int c = min(max(cd[t], 0), n_c - 1);
      const float cen = cb[(size_t)c * n_q + lane];
      const uint8_t* rt = rs + (size_t)t * m;
      float resid = lb[(size_t)rt[0] * n_q + lane];
      for (int s = 1; s < m; ++s)
        resid = resid + lb[((size_t)s * ksub + rt[s]) * n_q + lane];
      const float full = cen + resid;
      full_max = full > full_max ? full : full_max;
      if (use_filter && cen > th_r) {
        kept_max = full > kept_max ? full : kept_max;
        ++n_keep;
      }
    }
  }
  float colmax = full_max;
  if (use_filter && n_keep > 0)
    colmax = n_keep < cap ? (kept_max > NEG ? kept_max : NEG) : kept_max;
  colmax = lane < n_q && qm[lane] ? colmax : 0.0f;
  return term_sum_lanes(colmax, n_q);
}

}  // namespace emvb
