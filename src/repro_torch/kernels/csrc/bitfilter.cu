// Unfused EMVB Eq. 4 over the whole corpus for a micro-batch of queries
// sharing one corpus: F[b, d] = popcount(OR over doc d's valid tokens t of
// bits[b, codes[d, t]]). No bitmap: every doc is scored.
//
// Replaces: repro/kernels/bitfilter.py::bitfilter (Pallas body
// _bitfilter_kernel, bitfilter.py:33, pallas_call :53), batched: row b is
// the reference kernel on query b's words.
//
// What bounds it on the H100: bytes. It must read every doc's valid-token
// codes (at most n_docs x cap int32 = 2.83 GB at MS MARCO width) and
// lengths, read the word table (B x n_c x 4 B) and write F (B x n_docs
// int32, 1.13 GB at B = 32): about 1.2 ms at 3.35 TB/s at B = 32. Beyond
// bytes, it gathers one word per (valid token, query): random reads that
// the word table's size (1 MiB per query at n_c = 2^18) keeps in L2, not
// shared memory.
//
// What the design does about it:
//  * The word table is first transposed to (n_c, B) (emvb::transpose_words,
//    which the fused prefilter's dense form also reads), so one token's B
//    words are contiguous: at B = 32 a token costs one 128-byte line.
//  * The codes are streamed once for all B queries: a warp takes one doc,
//    its lanes split into (token group, query) pairs, and each token's code
//    is read once and used by every query (emvb::doc_word_or, the dense
//    form of the OR; the fused prefilter runs it on docs with many
//    candidate queries and the sparse one, emvb::chunk_word_or, on the
//    rest).
//  * A block scores a tile of TILE docs into shared memory and writes F out
//    row by row, so the stores of F are coalesced.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int TILE = 256;      // docs per block
constexpr int THREADS = 256;   // 8 warps, TILE / 8 docs each

// bits (B, n_c) -> bitsT (n_c, B). grid ceil(n_c / 32), THREADS threads.
__global__ void bitfilter_transpose_kernel(const uint32_t* __restrict__ bits,
                                           int B, int n_c,
                                           uint32_t* __restrict__ bitsT) {
  emvb::transpose_words(bits, B, n_c, bitsT);
}

// F for every (query, doc) of one tile. Shared: sF[B][TILE].
// grid ceil(n_docs / TILE).
__global__ void bitfilter_kernel(const int32_t* __restrict__ codes,
                                 const int32_t* __restrict__ doc_lens,
                                 const uint32_t* __restrict__ bitsT, int B,
                                 int n_c, int n_docs, int cap,
                                 int32_t* __restrict__ F) {
  extern __shared__ int32_t sF[];
  const size_t d0 = (size_t)blockIdx.x * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Q = next_pow2(B);          // lanes per token group
  const int G = 32 / Q;                // token groups per warp
  const int bq = lane % Q, g = lane / Q;
  for (int t = warp; t < TILE; t += nwarps) {
    const size_t d = d0 + t;
    if (d >= (size_t)n_docs) break;    // warp-uniform
    const int len = min(max(doc_lens[d], 0), cap);
    const uint32_t acc = emvb::doc_word_or(codes + d * cap, len, n_c, bitsT, B,
                                           bq, g, G, Q, bq < B);
    if (g == 0 && bq < B) sF[bq * TILE + t] = __popc(acc);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < B * TILE; j += blockDim.x) {
    const int b = j / TILE, t = j % TILE;
    const size_t d = d0 + t;
    if (d < (size_t)n_docs) F[(size_t)b * n_docs + d] = sF[j];
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers; B <= 32. bits (B, n_c) u32; codes
// (n_docs, cap) i32; doc_lens (n_docs,) i32. Scratch: bitsT (n_c, B) u32.
// Output: F (B, n_docs) i32.
int bitfilter_batched(const uint32_t* bits, const int32_t* codes,
                      const int32_t* doc_lens, int B, int n_c, int n_docs,
                      int cap, uint32_t* bitsT, int32_t* F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  bitfilter_transpose_kernel<<<(n_c + 31) / 32, THREADS, 0, st>>>(
      bits, B, n_c, bitsT);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = (size_t)B * TILE * sizeof(int32_t);   // <= 32 KiB
  bitfilter_kernel<<<(n_docs + TILE - 1) / TILE, THREADS, smem, st>>>(
      codes, doc_lens, bitsT, B, n_c, n_docs, cap, F);
  return cudaGetLastError();
}

}  // extern "C"
