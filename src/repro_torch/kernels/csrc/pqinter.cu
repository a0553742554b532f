// Fused EMVB phases 3-4 over each query's phase-2 survivors: centroid
// interaction S̄ (Eq. 2), the top-n_docs cut, PQ late interaction with the
// dynamic term filter (Eq. 5/6) and the final top-k.
//
// Replaces: repro/kernels/pqinter.py::pqinter_batched (Pallas body
// _pqinter_batched_kernel, pqinter.py:256, which inlines
// cinter.py::sbar_block_batched and pqscore.py::eq56_block_batched) and, at
// B = 1, pqinter.py::pqinter (_pqinter_kernel, :87).
//
// What bounds it on the H100: the bytes it must move are small — the
// survivors' codes, residual codes and lengths, the LUT (512 KiB per query
// at n_q = 32, m = 16, K = 256) and the rows of CS^T the survivors' tokens
// touch. What costs time is latency: per (doc, token) a dependent chain of
// m LUT reads, and two selections per query.
//
// What the design does about it:
//  * One warp per document, one lane per query term (n_q <= 32). A row of
//    CS^T and a row of the flattened (m*K, n_q) LUT are n_q contiguous
//    floats, so every gather is one coalesced 128-byte load at n_q = 32.
//    The LUT is read through L2, not narrowed (narrowing changes bits).
//  * Bit-exact arithmetic: the residual is the reference's chain
//    lut[s=0] + lut[s=1] + ... + lut[s=m-1], added to the centroid score;
//    the per-term max keeps the reference's -1e9 floor for invalid tokens
//    and Eq. 6's full-max fallback; term_sum is lane 0 + lane 1 + ... in
//    that order through serial shuffles (a shuffle tree would change bits).
//  * Both cuts pack (score, position) into unique 64-bit keys —
//    (S̄ desc, survivor position asc) for phase 3 and (score desc, phase-3
//    rank asc) for phase 4, the order the reference's running merges give —
//    and sort them in shared memory, one block per query.
//  * The per-document math (emvb::sbar_doc, emvb::eq56_doc in doc_math.cuh)
//    is the one the unfused cinter.cu and pqscore.cu run, so the two lanes
//    agree to the bit by construction.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int WARPS = 8;

// Pass 1: S̄ of every survivor row. grid (ceil(nf / WARPS), B).
__global__ void sbar_kernel(const float* __restrict__ cs_t,
                            const int32_t* __restrict__ codes,
                            const int32_t* __restrict__ lens,
                            const uint8_t* __restrict__ qmask, int nf, int cap,
                            int n_c, int n_q, float* __restrict__ sbar_all) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (p >= nf) return;                                   // warp-uniform
  const size_t row = (size_t)b * nf + p;
  const float s = emvb::sbar_doc(cs_t + (size_t)b * n_c * n_q,
                                 codes + row * cap, lens[row],
                                 qmask + (size_t)b * n_q, cap, n_c, n_q, lane);
  if (lane == 0) sbar_all[row] = s;
}

// Pass 1 cut: top-n_docs by (S̄ desc, position asc). One block per query.
__global__ void select1_kernel(const float* __restrict__ sbar_all, int nf,
                               int n_docs, int P, int32_t* __restrict__ sel2,
                               float* __restrict__ sbar) {
  extern __shared__ unsigned long long k1[];
  const int b = blockIdx.x;
  const float* sb = sbar_all + (size_t)b * nf;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    k1[i] = i < nf ? ((unsigned long long)ordered_bits(sb[i]) << 32) |
                         (0xffffffffu - (unsigned)i)
                   : 0ull;
  __syncthreads();
  bitonic_sort_desc<unsigned long long>(k1, P);
  for (int r = threadIdx.x; r < n_docs; r += blockDim.x) {
    const int i = (int)(0xffffffffu - (unsigned)(k1[r] & 0xffffffffull));
    sel2[(size_t)b * n_docs + r] = i;
    sbar[(size_t)b * n_docs + r] = sb[i];
  }
}

// Pass 2: Eq. 5/6 score of each phase-3 winner, in rank order.
// grid (ceil(n_docs / WARPS), B).
__global__ void eq56_kernel(const float* __restrict__ cs_t,
                            const float* __restrict__ lut2,
                            const int32_t* __restrict__ codes,
                            const uint8_t* __restrict__ res,
                            const int32_t* __restrict__ lens,
                            const uint8_t* __restrict__ qmask,
                            const int32_t* __restrict__ sel2, int nf, int cap,
                            int n_c, int n_q, int m, int ksub, float th_r,
                            int use_filter, int n_docs,
                            float* __restrict__ score2) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (r >= n_docs) return;                               // warp-uniform
  const int p = sel2[(size_t)b * n_docs + r];
  const size_t row = (size_t)b * nf + p;
  const float s = emvb::eq56_doc(
      cs_t + (size_t)b * n_c * n_q, lut2 + (size_t)b * m * ksub * n_q,
      codes + row * cap, res + row * cap * m, lens[row],
      qmask + (size_t)b * n_q, cap, n_c, n_q, m, ksub, th_r, use_filter, lane);
  if (lane == 0) score2[(size_t)b * n_docs + r] = s;
}

// Pass 2 cut: top-k by (score desc, phase-3 rank asc). One block per query.
__global__ void select2_kernel(const float* __restrict__ score2,
                               const int32_t* __restrict__ sel2, int n_docs,
                               int k, int P, float* __restrict__ scores,
                               int32_t* __restrict__ pos) {
  extern __shared__ unsigned long long k2[];
  const int b = blockIdx.x;
  const float* sc = score2 + (size_t)b * n_docs;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    k2[i] = i < n_docs ? ((unsigned long long)ordered_bits(sc[i]) << 32) |
                             (0xffffffffu - (unsigned)i)
                       : 0ull;
  __syncthreads();
  bitonic_sort_desc<unsigned long long>(k2, P);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int r = (int)(0xffffffffu - (unsigned)(k2[j] & 0xffffffffull));
    scores[(size_t)b * k + j] = sc[r];
    pos[(size_t)b * k + j] = sel2[(size_t)b * n_docs + r];
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers. cs_t (B, n_c, n_q) f32; lut2
// (B, m*ksub, n_q) f32; codes (B, nf, cap) i32; res (B, nf, cap, m) u8;
// lens (B, nf) i32; qmask (B, n_q) u8. Scratch: sbar_all (B, nf) f32,
// score2 (B, n_docs) f32. Outputs: scores/pos (B, k), sel2/sbar
// (B, n_docs).
int pqinter_batched(const float* cs_t, const float* lut2, const int32_t* codes,
                    const uint8_t* res, const int32_t* lens,
                    const uint8_t* qmask, int B, int nf, int cap, int n_c,
                    int n_q, int m, int ksub, float th_r, int use_filter,
                    int n_docs, int k, float* sbar_all, float* score2,
                    float* scores, int32_t* pos, int32_t* sel2, float* sbar,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int threads = WARPS * 32;
  sbar_kernel<<<dim3((nf + WARPS - 1) / WARPS, B), threads, 0, st>>>(
      cs_t, codes, lens, qmask, nf, cap, n_c, n_q, sbar_all);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int P1 = next_pow2(nf);
  select1_kernel<<<B, 1024, P1 * sizeof(unsigned long long), st>>>(
      sbar_all, nf, n_docs, P1, sel2, sbar);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  eq56_kernel<<<dim3((n_docs + WARPS - 1) / WARPS, B), threads, 0, st>>>(
      cs_t, lut2, codes, res, lens, qmask, sel2, nf, cap, n_c, n_q, m, ksub,
      th_r, use_filter, n_docs, score2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int P2 = next_pow2(n_docs);
  select2_kernel<<<B, 1024, P2 * sizeof(unsigned long long), st>>>(
      score2, sel2, n_docs, k, P2, scores, pos);
  return cudaGetLastError();
}

}  // extern "C"
