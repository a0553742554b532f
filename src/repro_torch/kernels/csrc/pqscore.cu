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
// B x docs floats out. What costs time is latency: per (doc, token) a chain
// of m LUT reads addressed by the token's residual codes, and at B = 32 the
// L2 reads of those 128-byte LUT rows (~1.1 GB for 8,192 winners of ~67
// tokens).
//
// What the design does about it: it is the fused pqinter's Eq. 5/6 pass
// (emvb::eq56_block) on rows read directly instead of through sel2. One
// block a doc, its tokens split over E_SPLIT warps, one lane per query
// term: a row of CS^T and a row of the flattened (m*K, n_q) LUT are n_q
// contiguous floats, so every gather is one coalesced 128-byte load at
// n_q = 32; the LUT is read through L2, not narrowed (narrowing changes
// bits). For m = 16 (emvb-msmarco) m is a compile-time constant, so a
// token's 16 residual codes arrive in one vector load and its 16 LUT reads
// are all in flight before the first add; any other m runs the serial
// form. The warps' per-term states merge exactly (order-free maxima and
// counts), and Eq. 6's corner cases and term_sum run once per doc.
//
// CS^T is float32 or bf16 (pqscore_kernel<M, T>). On bf16 a token's full
// score is its widened bf16 centroid score plus the float32 residual, and
// Eq. 6 compares the centroid score with th_r rounded to bf16 on the host,
// as the reference's eq56_block does (pqscore.py:52-62).
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int E_SPLIT = 8;     // warps a doc

// grid (nd, B), one doc a block; M is m when known at compile time, else 0.
// Three blocks an SM: without the bound the compiler gives the m = 16 form
// more registers and two blocks an SM, fewer warps to hide the LUT reads.
template <int M, typename T>
__global__ void __launch_bounds__(E_SPLIT * 32, 3)
pqscore_kernel(const T* __restrict__ cs_t, const float* __restrict__ lut2,
               const int32_t* __restrict__ codes,
               const uint8_t* __restrict__ res,
               const int32_t* __restrict__ lens,
               const uint8_t* __restrict__ qmask, int nd, int cap, int n_c,
               int n_q, int m, int ksub, float th_r, int use_filter,
               float* __restrict__ score) {
  emvb::eq56_block<M, E_SPLIT>(cs_t, lut2, codes, res, lens, qmask, nullptr,
                               nd, nd, cap, n_c, n_q, m, ksub, th_r,
                               use_filter, score);
}

// One launch on cs_t (B, n_c, n_q) of T; lut2 (B, m*ksub, n_q) f32;
// codes (B, nd, cap) i32; res (B, nd, cap, m) u8; lens (B, nd) i32; qmask
// (B, n_q) u8; th_r rounded to the CS type. Output: score (B, nd) f32.
template <typename T>
int launch(const T* cs_t, const float* lut2, const int32_t* codes,
           const uint8_t* res, const int32_t* lens, const uint8_t* qmask,
           int B, int nd, int cap, int n_c, int n_q, int m, int ksub,
           float th_r, int use_filter, float* score, cudaStream_t st) {
  const dim3 grid(nd, B);
  if (emvb::eq56_vector_m16(m, res))
    pqscore_kernel<16, T><<<grid, E_SPLIT * 32, 0, st>>>(
        cs_t, lut2, codes, res, lens, qmask, nd, cap, n_c, n_q, m, ksub, th_r,
        use_filter, score);
  else
    pqscore_kernel<0, T><<<grid, E_SPLIT * 32, 0, st>>>(
        cs_t, lut2, codes, res, lens, qmask, nd, cap, n_c, n_q, m, ksub, th_r,
        use_filter, score);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers; qmask may be null (every term live).
// cs_t (B, n_c, n_q) f32, or bf16 when cs_bf16; the other operands as in
// launch.
int pqscore_batched(const void* cs_t, int cs_bf16, const float* lut2,
                    const int32_t* codes, const uint8_t* res,
                    const int32_t* lens, const uint8_t* qmask, int B, int nd,
                    int cap, int n_c, int n_q, int m, int ksub, float th_r,
                    int use_filter, float* score, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_cs(cs_t, cs_bf16, [&](auto p) {
    return launch(p, lut2, codes, res, lens, qmask, B, nd, cap, n_c, n_q, m,
                  ksub, th_r, use_filter, score, st);
  });
}

}  // extern "C"
