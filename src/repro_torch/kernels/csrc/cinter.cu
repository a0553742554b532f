// Unfused EMVB phase 3: the centroid interaction S̄ (Eq. 2) of every
// survivor of each query: per live term the max over valid tokens of
// cs_t[code, term], masked terms 0.0, then term_sum.
//
// Replaces: repro/kernels/cinter.py::cinter (Pallas body _cinter_kernel,
// cinter.py:77, calling sbar_block :31; pallas_call :99), batched: row b is
// the reference kernel on query b.
//
// What bounds it on the H100: the bytes are small — the survivors' codes
// and lengths, the rows of CS^T their tokens touch (n_q floats each) and
// B x docs floats out. What costs time is latency: per (doc, token) one
// dependent gather of a CS^T row.
//
// What the design does about it: one warp per document and one lane per
// query term (n_q <= 32), its tokens in series. A row of CS^T is n_q
// contiguous floats, so each token's gather is one coalesced 128-byte load
// at n_q = 32. The per-document math is emvb::sbar_doc, a serial loop over
// the pieces (sbar_token, sbar_finish) that the fused pqinter's
// token-split S̄ pass merges, so the two lanes agree to the bit.
//
// CS^T is float32 or bf16 (cinter_kernel<T>). On bf16 S̄ is the reference's
// bf16 sum (per-term bf16 maxima, the float32 term chain rounded once to
// bf16), written widened to float32 as the reference kernel writes it
// (cinter.py:109); the rows it gathers are half as many bytes.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int WARPS = 8;

// grid (ceil(nd / WARPS), B).
template <typename T>
__global__ void cinter_kernel(const T* __restrict__ cs_t,
                              const int32_t* __restrict__ codes,
                              const int32_t* __restrict__ lens,
                              const uint8_t* __restrict__ qmask, int nd,
                              int cap, int n_c, int n_q,
                              float* __restrict__ sbar) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (p >= nd) return;                                   // warp-uniform
  const size_t row = (size_t)b * nd + p;
  const float s = emvb::sbar_doc(cs_t + (size_t)b * n_c * n_q,
                                 codes + row * cap, lens[row],
                                 emvb::mask_row(qmask, b, n_q), cap, n_c, n_q,
                                 lane);
  if (lane == 0) sbar[row] = s;
}

}  // namespace

extern "C" {

// All pointers are device pointers; qmask may be null (every term live).
// cs_t (B, n_c, n_q) f32, or bf16 when cs_bf16; codes (B, nd, cap) i32;
// lens (B, nd) i32; qmask (B, n_q) u8. Output: sbar (B, nd) f32.
int cinter_batched(const void* cs_t, int cs_bf16, const int32_t* codes,
                   const int32_t* lens, const uint8_t* qmask, int B, int nd,
                   int cap, int n_c, int n_q, float* sbar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nd + WARPS - 1) / WARPS, B);
  return with_cs(cs_t, cs_bf16, [&](auto p) {
    cinter_kernel<<<grid, WARPS * 32, 0, st>>>(p, codes, lens, qmask, nd, cap,
                                               n_c, n_q, sbar);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
