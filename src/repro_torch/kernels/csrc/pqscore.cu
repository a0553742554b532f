// Unfused EMVB phase 4: the PQ late-interaction score (Eq. 5, or Eq. 6 with
// the dynamic term filter) of every phase-3 winner of each query.
//
// Replaces: repro/kernels/pqscore.py::pqscore (Pallas body _pqscore_kernel,
// pqscore.py:116, calling eq56_block :33; pallas_call :149), batched: row b
// is the reference kernel on query b. The reference widens the residual
// codes to int32 in its wrapper (:139); here they stay uint8 in memory.
//
// What bounds it on the H100: the bytes are small — the winners' codes,
// residual codes (m bytes a token) and lengths, the CS^T rows their tokens
// touch, the LUT (512 KiB per query at n_q = 32, m = 16, K = 256) and
// B x docs floats out. What costs time is latency: per (doc, token) a
// dependent chain of m LUT reads.
//
// What the design does about it: one warp per document and one lane per
// query term, its tokens in series. A row of CS^T and a row of the flattened
// (m*K, n_q) LUT are n_q contiguous floats, so every gather is one
// coalesced 128-byte load at n_q = 32; the LUT is read through L2, not
// narrowed (narrowing changes bits). The per-document math, Eq. 6's corner
// cases included, is emvb::eq56_doc, a serial loop over the pieces
// (eq56_full, eq56_token, eq56_finish) that the fused pqinter's token-split
// Eq. 5/6 pass merges.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int WARPS = 8;

// grid (ceil(nd / WARPS), B).
__global__ void pqscore_kernel(const float* __restrict__ cs_t,
                               const float* __restrict__ lut2,
                               const int32_t* __restrict__ codes,
                               const uint8_t* __restrict__ res,
                               const int32_t* __restrict__ lens,
                               const uint8_t* __restrict__ qmask, int nd,
                               int cap, int n_c, int n_q, int m, int ksub,
                               float th_r, int use_filter,
                               float* __restrict__ score) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (p >= nd) return;                                   // warp-uniform
  const size_t row = (size_t)b * nd + p;
  const float s = emvb::eq56_doc(
      cs_t + (size_t)b * n_c * n_q, lut2 + (size_t)b * m * ksub * n_q,
      codes + row * cap, res + row * cap * m, lens[row],
      emvb::mask_row(qmask, b, n_q), cap, n_c, n_q, m, ksub, th_r, use_filter,
      lane);
  if (lane == 0) score[row] = s;
}

}  // namespace

extern "C" {

// All pointers are device pointers; qmask may be null (every term live).
// cs_t (B, n_c, n_q) f32; lut2 (B, m*ksub, n_q) f32; codes (B, nd, cap)
// i32; res (B, nd, cap, m) u8; lens (B, nd) i32; qmask (B, n_q) u8.
// Output: score (B, nd) f32.
int pqscore_batched(const float* cs_t, const float* lut2, const int32_t* codes,
                    const uint8_t* res, const int32_t* lens,
                    const uint8_t* qmask, int B, int nd, int cap, int n_c,
                    int n_q, int m, int ksub, float th_r, int use_filter,
                    float* score, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pqscore_kernel<<<dim3((nd + WARPS - 1) / WARPS, B), WARPS * 32, 0, st>>>(
      cs_t, lut2, codes, res, lens, qmask, nd, cap, n_c, n_q, m, ksub, th_r,
      use_filter, score);
  return cudaGetLastError();
}

}  // extern "C"
