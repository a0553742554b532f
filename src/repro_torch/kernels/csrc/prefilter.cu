// Fused EMVB phases 1b-2 for a micro-batch of queries sharing one corpus
// (score_all mode): stacked bit vectors, Eq. 4 filter scores, and the exact
// top-n_filter by the unique key (f + 1) << 25 | (2^25 - 1 - doc_id).
//
// Replaces: repro/kernels/prefilter.py::prefilter_batched (Pallas body
// _prefilter_batched_kernel, prefilter.py:106) and, at B = 1,
// prefilter.py::prefilter (_prefilter_kernel, :62).
//
// What bounds it on the H100: bytes. It must read the CS (B x n_q x n_c
// fp32, 1.07 GB at B = 32 and n_c = 2^18), the candidate bitmap (B x n_docs
// bytes, 0.28 GB), the doc lengths and the codes of every doc that is some
// query's candidate (at most n_docs x cap int32 = 2.83 GB at MS MARCO
// width), and write the bit table. That is at most about 4.2 GB, 1.3 ms at
// 3.35 TB/s at B = 32 (spec arithmetic; chip_smoke.py computes the bound
// from the run's own candidates). Beyond bytes, Eq. 4 gathers one bit word
// per (valid token, query) pair of each candidate: random 4-byte reads.
//
// What the design does about it:
//  * The codes are streamed ONCE for all B queries: a warp takes one doc,
//    its lanes split into (token group, query) pairs, and each token's code
//    is read once and used by every query. A doc that is no query's
//    candidate is skipped without reading its codes, and a lane gathers
//    words only for the docs that are its own query's candidates.
//  * The bit table is written transposed, (n_c, B), so one token's B words
//    are contiguous: at B = 32 a token costs one 128-byte line. At
//    n_c = 2^18 the table is 1 MiB per query, too large for shared memory
//    (227 KB), so it is read through L2 (32 MiB at B = 32 fits its 50 MB).
//  * Token validity is t < doc_lens[d] (what token_mask() computes), so no
//    (n_docs, cap) mask is read.
//  * Selection needs no running merge: the keys are unique, so any exact
//    selection equals lax.top_k's. F takes 34 values (-1..32): a histogram
//    per (query, tile) gives the threshold f*, per-tile prefix counts give
//    every selected doc its slot (docs with f > f*, then the lowest ids with
//    f == f*), and one block per query sorts its n_filter keys. Only F
//    (B x n_docs int8) goes through device memory between the passes.
//  * The column pack and a doc's word OR (emvb::pack_column,
//    emvb::doc_word_or in doc_math.cuh) are the ones the unfused bitpack.cu
//    and bitfilter.cu run.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int ID_BITS = 25;
constexpr int MAX_ID = (1 << ID_BITS) - 1;
constexpr int NBINS = 34;      // f + 1 in [0, 33]
constexpr int TILE = 1024;     // docs per tile
constexpr int THREADS = 256;   // 8 warps; 4 docs per thread in collect
constexpr int KEY_PAD = -2147483647 - 1;   // below every real key

// Pass 1: bit words. bits (B, n_c) is the API output; bitsT (n_c, B) is
// the gather-friendly copy the score pass reads.
__global__ void pack_kernel(const float* __restrict__ cs, float th,
                            const uint8_t* __restrict__ qmask, int B, int n_q,
                            int n_c, uint32_t* __restrict__ bits,
                            uint32_t* __restrict__ bitsT) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_c) return;
  for (int b = 0; b < B; ++b) {
    const uint32_t w = emvb::pack_column(cs + (size_t)b * n_q * n_c + c, n_c,
                                         th, qmask + (size_t)b * n_q, n_q);
    bits[(size_t)b * n_c + c] = w;
    bitsT[(size_t)c * B + b] = w;
  }
}

// Pass 2: F for every (query, doc) of one tile, plus its histogram.
// Shared: sF[B][TILE] (bitmap in, F out) and sh[B][NBINS].
__global__ void score_kernel(const int32_t* __restrict__ codes,
                             const int32_t* __restrict__ doc_lens,
                             const uint8_t* __restrict__ bitmap,
                             const uint32_t* __restrict__ bitsT, int B,
                             int n_c, int n_docs, int cap, int n_tiles,
                             int8_t* __restrict__ F, int32_t* __restrict__ hist) {
  extern __shared__ unsigned char smem[];
  int8_t* sF = reinterpret_cast<int8_t*>(smem);
  int* sh = reinterpret_cast<int*>(smem + ((B * TILE + 15) & ~15));
  const int tile = blockIdx.x;
  const size_t d0 = (size_t)tile * TILE;
  for (int j = threadIdx.x; j < B * TILE; j += blockDim.x) {
    const int b = j / TILE, t = j % TILE;
    const size_t d = d0 + t;
    sF[j] = d < (size_t)n_docs ? (int8_t)(bitmap[(size_t)b * n_docs + d] != 0)
                               : 0;
  }
  for (int j = threadIdx.x; j < B * NBINS; j += blockDim.x) sh[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int Q = next_pow2(B);          // lanes per token group
  const int G = 32 / Q;                // token groups per warp
  const int bq = lane % Q, g = lane / Q;
  int n_neg = 0;                       // this lane's non-candidates (F = -1)
  for (int t = warp; t < TILE; t += nwarps) {
    const size_t d = d0 + t;
    if (d >= (size_t)n_docs) break;    // warp-uniform
    // A doc that is no query's candidate scores -1 everywhere: its codes
    // are not read. A lane gathers bit words only for its own candidates.
    const bool cand = bq < B && sF[bq * TILE + t] != 0;
    if (!__any_sync(0xffffffffu, cand)) {
      if (g == 0 && bq < B) {
        sF[bq * TILE + t] = -1;
        ++n_neg;
      }
      continue;
    }
    const int len = min(max(doc_lens[d], 0), cap);
    const uint32_t acc = emvb::doc_word_or(codes + d * cap, len, n_c, bitsT, B,
                                           bq, g, G, Q, cand);
    if (g == 0 && bq < B) {
      const int f = cand ? __popc(acc) : -1;
      sF[bq * TILE + t] = (int8_t)f;
      if (cand) atomicAdd(&sh[bq * NBINS + f + 1], 1);
      else ++n_neg;
    }
  }
  if (g == 0 && bq < B && n_neg) atomicAdd(&sh[bq * NBINS], n_neg);
  __syncthreads();
  for (int j = threadIdx.x; j < B * TILE; j += blockDim.x) {
    const int b = j / TILE, t = j % TILE;
    const size_t d = d0 + t;
    if (d < (size_t)n_docs) F[(size_t)b * n_docs + d] = sF[j];
  }
  for (int j = threadIdx.x; j < B * NBINS; j += blockDim.x) {
    const int b = j / NBINS, bin = j % NBINS;
    hist[((size_t)b * n_tiles + tile) * NBINS + bin] = sh[j];
  }
}

// Pass 3, one block per query: the threshold bin, and per tile the
// exclusive prefix counts of docs above it (hi) and on it (eq).
// params[b] = {f* + 1, c_hi, need}.
__global__ void threshold_kernel(const int32_t* __restrict__ hist, int n_tiles,
                                 int n_filter, int32_t* __restrict__ off_hi,
                                 int32_t* __restrict__ off_eq,
                                 int32_t* __restrict__ params) {
  __shared__ int tot[NBINS];
  __shared__ int sw[32];
  __shared__ int sp[3];
  const int b = blockIdx.x;
  const int32_t* hb = hist + (size_t)b * n_tiles * NBINS;
  for (int j = threadIdx.x; j < NBINS; j += blockDim.x) tot[j] = 0;
  __syncthreads();
  for (int tl = threadIdx.x; tl < n_tiles; tl += blockDim.x) {
    for (int bin = 0; bin < NBINS; ++bin) {
      const int v = hb[(size_t)tl * NBINS + bin];
      if (v) atomicAdd(&tot[bin], v);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int cum = 0, bin = NBINS - 1;
    for (; bin > 0; --bin) {
      if (cum + tot[bin] >= n_filter) break;
      cum += tot[bin];
    }
    sp[0] = bin;
    sp[1] = cum;
    sp[2] = n_filter - cum;
    params[b * 4 + 0] = bin;
    params[b * 4 + 1] = cum;
    params[b * 4 + 2] = n_filter - cum;
  }
  __syncthreads();
  const int fbin = sp[0];
  int carry_hi = 0, carry_eq = 0;
  int32_t* oh = off_hi + (size_t)b * (n_tiles + 1);
  int32_t* oe = off_eq + (size_t)b * (n_tiles + 1);
  for (int start = 0; start < n_tiles; start += blockDim.x) {
    const int tl = start + threadIdx.x;
    int hi = 0, eq = 0;
    if (tl < n_tiles) {
      const int32_t* row = hb + (size_t)tl * NBINS;
      for (int bin = fbin + 1; bin < NBINS; ++bin) hi += row[bin];
      eq = row[fbin];
    }
    int tot_hi, tot_eq;
    const int ph = block_excl_scan(hi, sw, &tot_hi);
    const int pe = block_excl_scan(eq, sw, &tot_eq);
    if (tl < n_tiles) {
      oh[tl] = carry_hi + ph;
      oe[tl] = carry_eq + pe;
    }
    carry_hi += tot_hi;
    carry_eq += tot_eq;
  }
  if (threadIdx.x == 0) {
    oh[n_tiles] = carry_hi;
    oe[n_tiles] = carry_eq;
  }
}

// Pass 4, grid (n_tiles, B): write every selected doc's key into its slot.
__global__ void collect_kernel(const int8_t* __restrict__ F, int n_docs,
                               int n_tiles, int n_filter,
                               const int32_t* __restrict__ off_hi,
                               const int32_t* __restrict__ off_eq,
                               const int32_t* __restrict__ params,
                               int32_t* __restrict__ keys) {
  __shared__ int sw[32];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int fstar = params[b * 4 + 0] - 1;
  const int c_hi = params[b * 4 + 1], need = params[b * 4 + 2];
  const int32_t* oh = off_hi + (size_t)b * (n_tiles + 1);
  const int32_t* oe = off_eq + (size_t)b * (n_tiles + 1);
  const int h0 = oh[tile], h1 = oh[tile + 1];
  const int e0 = oe[tile], e1 = oe[tile + 1];
  if (h1 == h0 && (e1 == e0 || e0 >= need)) return;   // block-uniform
  constexpr int PER = TILE / THREADS;
  const size_t dbase = (size_t)tile * TILE + threadIdx.x * PER;
  int f[PER];
  int nh = 0, ne = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const size_t d = dbase + j;
    f[j] = d < (size_t)n_docs ? (int)F[(size_t)b * n_docs + d] : -2;
    nh += f[j] > fstar;
    ne += f[j] == fstar;
  }
  int tot;
  int ph = block_excl_scan(nh, sw, &tot);
  int pe = block_excl_scan(ne, sw, &tot);
  int32_t* kb = keys + (size_t)b * n_filter;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int d = (int)(dbase + j);
    const int key = ((f[j] + 1) << ID_BITS) + (MAX_ID - d);
    if (f[j] > fstar) {
      kb[h0 + ph++] = key;
    } else if (f[j] == fstar) {
      const int r = e0 + pe++;
      if (r < need) kb[c_hi + r] = key;
    }
  }
}

// Pass 5, one block per query: sort the n_filter keys, decode (f, id).
__global__ void sort_kernel(const int32_t* __restrict__ keys, int n_filter,
                            int P, int32_t* __restrict__ scores,
                            int32_t* __restrict__ ids) {
  extern __shared__ int skeys[];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    skeys[i] = i < n_filter ? keys[(size_t)b * n_filter + i] : KEY_PAD;
  __syncthreads();
  bitonic_sort_desc<int>(skeys, P);
  for (int i = threadIdx.x; i < n_filter; i += blockDim.x) {
    const int key = skeys[i];
    scores[(size_t)b * n_filter + i] = (key >> ID_BITS) - 1;
    ids[(size_t)b * n_filter + i] = MAX_ID - (key & MAX_ID);
  }
}

}  // namespace

extern "C" {

int prefilter_tile() { return TILE; }
int prefilter_nbins() { return NBINS; }

// All pointers are device pointers; scratch is allocated by the caller:
// bitsT (n_c*B u32), F (B*n_docs i8), hist (B*n_tiles*NBINS i32),
// off_hi/off_eq (B*(n_tiles+1) i32), params (B*4 i32), keys (B*n_filter).
int prefilter_batched(const float* cs, float th, const uint8_t* qmask,
                      const int32_t* codes, const int32_t* doc_lens,
                      const uint8_t* bitmap, int B, int n_q, int n_c,
                      int n_docs, int cap, int n_filter, uint32_t* bits,
                      uint32_t* bitsT, int8_t* F, int32_t* hist,
                      int32_t* off_hi, int32_t* off_eq, int32_t* params,
                      int32_t* keys, int32_t* scores, int32_t* ids,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n_docs + TILE - 1) / TILE;
  cudaError_t err;
  pack_kernel<<<(n_c + 255) / 256, 256, 0, st>>>(cs, th, qmask, B, n_q, n_c,
                                                 bits, bitsT);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = ((B * TILE + 15) & ~15) + B * NBINS * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(score_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  score_kernel<<<n_tiles, THREADS, smem, st>>>(codes, doc_lens, bitmap, bitsT,
                                               B, n_c, n_docs, cap, n_tiles, F,
                                               hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  threshold_kernel<<<B, 1024, 0, st>>>(hist, n_tiles, n_filter, off_hi, off_eq,
                                       params);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  collect_kernel<<<dim3(n_tiles, B), THREADS, 0, st>>>(
      F, n_docs, n_tiles, n_filter, off_hi, off_eq, params, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int P = next_pow2(n_filter);
  sort_kernel<<<B, 1024, P * sizeof(int), st>>>(keys, n_filter, P, scores,
                                                ids);
  return cudaGetLastError();
}

}  // extern "C"
