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
// int32, 1.13 GB at B = 32): about 1.1 ms at 3.35 TB/s at B = 32, 0.73 ms at
// B = 1. Beyond bytes, Eq. 4 gathers the B words of each valid token's
// centroid: a 128-byte row of the transposed word table at B = 32, which
// only L2 holds (32 MiB). Gathering every token's row is ~76 GB of L2 reads
// at MS MARCO width, ~15 ms. But a row whose B words are all zero (no live
// term of any query in the launch beats th at that centroid) adds nothing
// to an OR, and a query lights few centroids.
//
// What the design does about it:
//  * Pass `rows` transposes the word table to (n_c, B), so one token's B
//    words are contiguous, and marks in an occupancy bitmap (n_c bits) the
//    rows with a bit set (emvb::transpose_words, which the fused
//    prefilter's dense form also runs, without the bitmap).
//  * Pass `score` is persistent: one block of SCORE_WARPS warps an SM,
//    loading the bitmap into shared memory once (where it does not fit
//    beside the warps' buffers, n_c > 319,488 at B = 32, the same test
//    reads it from global memory). Each warp scores groups of 32
//    neighbouring docs, whose codes are one contiguous run: it streams the
//    run into a ring of NBUF rounds in shared memory with cp.async (16
//    bytes a lane, VEC = 4 codes of one doc, when cap is a multiple of 4),
//    reading nothing past a doc's length, and tests each code's bit in the
//    bitmap. A round with no lit code costs its copy and these tests; the
//    lit ones gather their rows (emvb::lit_rows_or, several in flight a
//    lane) into the group's words in shared memory.
//  * F is zero-filled first (a memset: sequential writes). At the group's
//    end the warp writes its F one query row at a time, as coalesced
//    128-byte lines, and only the rows where some doc of the group has a
//    nonzero F: at B = 32 the 1.13 GB of F written as scattered 128-byte
//    lines beside the reads took more time than the reads themselves, and
//    a batch that lights few rows leaves most of F zero.
//
// Compact mode (per-query candidate codes (B, cand_cap, cap), the
// reference's engine.py:302-311 running bitfilter per query on its own
// buffer): entry point bitfilter_query, one pass `query`, a warp per
// (query, buffer slot) ORing query b's words of the slot's tokens, 128
// tokens a round with a lane's four gathers in flight. Word row b meets
// only query b's codes, so there is no transposed table and no bitmap; the
// buffer holds a few thousand slots a query.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int ROWS_THREADS = 256;
constexpr int SCORE_WARPS = 32;        // 1024 threads, one block an SM
constexpr int GROUP = 32;              // docs a warp scores and stores at once
constexpr int NBUF = 2;                // rounds in a warp's ring of codes

// Row pitch of a warp's group words sW (GROUP x P u32): odd, so the lanes
// of one doc's B queries, and the lanes of 32 docs' query b, hit 32 banks.
__host__ __device__ inline int words_pitch(int B) { return B | 1; }

// Shared bytes of one warp: its ring of codes (NBUF rounds of 32 VEC),
// each round's (doc, valid count) per lane, its list of lit codes and its
// group's words.
template <int VEC>
__host__ __device__ inline size_t warp_bytes(int B) {
  return ((size_t)(NBUF * 32 * VEC + NBUF * 32 + 32 * VEC +
                   GROUP * words_pitch(B)) * 4 + 15) & ~size_t(15);
}

__host__ __device__ inline size_t occ_bytes(int n_c, bool smem_occ) {
  return smem_occ ? ((size_t)(n_c + 31) / 32 * 4 + 15) & ~size_t(15) : 0;
}

// Pass 1: bits (B, n_c) -> bitsT (n_c, B) and occ (ceil(n_c / 32)): bit
// c % 32 of occ[c / 32] is set when row c of bitsT has a bit set. grid
// ceil(n_c / 32), ROWS_THREADS threads.
__global__ void bitfilter_rows_kernel(const uint32_t* __restrict__ bits, int B,
                                      int n_c, uint32_t* __restrict__ bitsT,
                                      uint32_t* __restrict__ occ) {
  emvb::transpose_words(bits, B, n_c, bitsT, occ);
}

// Pass 2: F of every (query, doc). A persistent grid: warp w of the grid
// scores groups w, w + (warps in the grid), ... of GROUP docs, cap / VEC
// rounds a group (round r: lane l takes the group's codes (32 r + l) VEC
// ... + VEC - 1). SMEM_OCC: the bitmap is read from shared memory, else
// from global memory.
template <bool SMEM_OCC, int VEC>
__global__ void __launch_bounds__(SCORE_WARPS * 32, 1)
bitfilter_score_kernel(const int32_t* __restrict__ codes,
                       const int32_t* __restrict__ doc_lens,
                       const uint32_t* __restrict__ bitsT,
                       const uint32_t* __restrict__ occ_g, int B, int n_c,
                       int n_docs, int cap, int32_t* __restrict__ F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = words_pitch(B);
  uint32_t* s_occ = reinterpret_cast<uint32_t*>(smem);
  int* ring = reinterpret_cast<int*>(smem + occ_bytes(n_c, SMEM_OCC) +
                                     warp * warp_bytes<VEC>(B));
  int* meta = ring + NBUF * 32 * VEC;  // (doc << 8) | valid codes, per lane
  int* list = meta + NBUF * 32;
  uint32_t* sW = reinterpret_cast<uint32_t*>(list + 32 * VEC);
  if (SMEM_OCC)
    for (int i = threadIdx.x; i < (n_c + 31) / 32; i += blockDim.x)
      s_occ[i] = occ_g[i];
  for (int i = lane; i < GROUP * P; i += 32) sW[i] = 0;
  __syncthreads();                     // the kernel's only block barrier

  const int n_groups = (n_docs + GROUP - 1) / GROUP;
  const int stride = gridDim.x * SCORE_WARPS;
  const int n_rounds = cap / VEC;                  // rounds a group
  int grp = blockIdx.x * SCORE_WARPS + warp;
  if (grp >= n_groups) return;                     // warp-uniform
  auto group_lens = [&](int gi) {
    const size_t d = (size_t)gi * GROUP + lane;
    return gi < n_groups && d < (size_t)n_docs ? __ldcs(doc_lens + d) : 0;
  };

  // The copy cursor runs NBUF - 1 rounds ahead of the scoring one: its
  // group, round, and the doc t and token tok of this lane's first code. A
  // round moves a lane 32 VEC codes on: dq docs and dr tokens.
  const int t0 = lane * VEC / cap, tok0 = lane * VEC % cap;
  const int dq = 32 * VEC / cap, dr = 32 * VEC % cap;
  int f_grp = grp, f_r = 0, f_t = t0, f_tok = tok0;
  int f_lens = group_lens(grp);                    // lane l: doc l's length
  int f_lens_next = group_lens(grp + stride);
  auto copy = [&](int slot) {
    const int len = min(max(__shfl_sync(FULL_MASK, f_lens, f_t), 0), cap);
    const int nv = min(max(len - f_tok, 0), VEC);
    const int32_t* src = nv > 0 ? codes + (size_t)f_grp * GROUP * cap +
                                      (size_t)(f_r * 32 + lane) * VEC
                                : codes;
    int* dst = ring + (slot * 32 + lane) * VEC;
    if constexpr (VEC == 4)
      cp_async16_zfill(dst, src, nv > 0 ? 16 : 0);
    else
      cp_async4_zfill(dst, src, nv > 0 ? 4 : 0);
    cp_async_commit();
    meta[slot * 32 + lane] = (f_t << 8) | nv;
    f_tok += dr;
    f_t += dq;
    if (f_tok >= cap) {
      f_tok -= cap;
      ++f_t;
    }
    if (++f_r == n_rounds) {
      f_r = 0;
      f_t = t0;
      f_tok = tok0;
      f_grp += stride;
      f_lens = f_lens_next;
      f_lens_next = group_lens(f_grp + stride);
    }
  };

  const int Q = next_pow2(B), G = 32 / Q, bq = lane % Q, g = lane / Q;
  for (int s = 0; s < NBUF - 1; ++s) copy(s);
  int slot = 0, r = 0;
  while (true) {
    copy(slot == 0 ? NBUF - 1 : slot - 1);         // the slot scored last
    cp_async_wait<NBUF - 1>();                     // this slot's copy done
    int v[VEC];
    if constexpr (VEC == 4) {
      const int4 q = reinterpret_cast<const int4*>(ring)[slot * 32 + lane];
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = ring[slot * 32 + lane];
    }
    const int mt = meta[slot * 32 + lane];
    const int t = mt >> 8, nv = mt & 0xff;
    int c[VEC];
    bool lit[VEC];
    bool any = false;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      c[k] = min(max(v[k], 0), n_c - 1);
      const uint32_t w =
          SMEM_OCC ? s_occ[c[k] >> 5] : occ_g[c[k] >> 5];
      lit[k] = k < nv && ((w >> (c[k] & 31)) & 1u);
      any |= lit[k];
    }
    if (__any_sync(FULL_MASK, any))
      emvb::lit_rows_or<VEC>(c, lit, t, bitsT, B, P, bq, g, G, list, sW);
    slot = slot == NBUF - 1 ? 0 : slot + 1;
    if (++r < n_rounds) continue;
    r = 0;                                         // the group is scored
    __syncwarp();
    const size_t d = (size_t)grp * GROUP + lane;
    for (int b = 0; b < B; ++b) {
      const uint32_t w = sW[lane * P + b];
      sW[lane * P + b] = 0;
      if (__any_sync(FULL_MASK, w != 0) && d < (size_t)n_docs)
        __stcs(F + (size_t)b * n_docs + d, __popc(w));
    }
    __syncwarp();
    grp += stride;
    if (grp >= n_groups) break;
  }
  cp_async_wait<0>();
}

// Compact mode: F[b, d] for every (query, buffer slot). grid
// (ceil(n_docs / SCORE_WARPS), B), SCORE_WARPS warps, a warp a slot.
__global__ void __launch_bounds__(SCORE_WARPS * 32)
bitfilter_query_kernel(const uint32_t* __restrict__ bits,
                       const int32_t* __restrict__ codes,
                       const int32_t* __restrict__ lens, int n_c, int n_docs,
                       int cap, int32_t* __restrict__ F) {
  constexpr int R = 4;                               // rounds of 32 tokens
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * SCORE_WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (d >= n_docs) return;                           // warp-uniform
  const size_t row = (size_t)b * n_docs + d;
  const int len = min(max(lens[row], 0), cap);
  const int32_t* cd = codes + row * cap;
  const uint32_t* wb = bits + (size_t)b * n_c;
  uint32_t w = 0;
  for (int base = 0; base < len; base += R * 32) {
    int c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tok = base + r * 32 + lane;
      c[r] = tok < len ? min(max(cd[tok], 0), n_c - 1) : -1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (c[r] >= 0) w |= wb[c[r]];
  }
  w = __reduce_or_sync(FULL_MASK, w);
  if (lane == 0) F[row] = __popc(w);
}

template <bool SMEM_OCC, int VEC>
int launch_score(const int32_t* codes, const int32_t* doc_lens,
                 const uint32_t* bitsT, const uint32_t* occ, int B, int n_c,
                 int n_docs, int cap, int32_t* F, cudaStream_t st) {
  auto kernel = bitfilter_score_kernel<SMEM_OCC, VEC>;
  const size_t smem =
      occ_bytes(n_c, SMEM_OCC) + SCORE_WARPS * warp_bytes<VEC>(B);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, SCORE_WARPS * 32, smem)) != cudaSuccess)
    return err;
  const int n_groups = (n_docs + GROUP - 1) / GROUP;
  const int grid = max(1, min(max(per_sm, 1) * sm_count(),
                              (n_groups + SCORE_WARPS - 1) / SCORE_WARPS));
  kernel<<<grid, SCORE_WARPS * 32, smem, st>>>(codes, doc_lens, bitsT, occ, B,
                                               n_c, n_docs, cap, F);
  return cudaGetLastError();
}

// The bitmap goes to shared memory while it fits beside the warps' buffers
// (on the H100, n_c <= 319,488 at B = 32 and 1,368,064 at B = 1); above
// that the same test reads it from global memory.
template <int VEC>
int launch_score_vec(const int32_t* codes, const int32_t* doc_lens,
                     const uint32_t* bitsT, const uint32_t* occ, int B,
                     int n_c, int n_docs, int cap, int32_t* F,
                     cudaStream_t st) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (occ_bytes(n_c, true) + SCORE_WARPS * warp_bytes<VEC>(B) <=
      (size_t)max_smem)
    return launch_score<true, VEC>(codes, doc_lens, bitsT, occ, B, n_c,
                                   n_docs, cap, F, st);
  return launch_score<false, VEC>(codes, doc_lens, bitsT, occ, B, n_c, n_docs,
                                  cap, F, st);
}

}  // namespace

extern "C" {

// Bytes of device scratch bitfilter_batched needs: bitsT (n_c, B) u32, then
// the occupancy bitmap (ceil(n_c / 32)) u32.
size_t bitfilter_scratch_bytes(int B, int n_c) {
  return ((size_t)n_c * B + (n_c + 31) / 32) * 4;
}

// All pointers are device pointers; B <= 32. bits (B, n_c) u32; codes
// (n_docs, cap) i32; doc_lens (n_docs,) i32. scratch: the bytes
// bitfilter_scratch_bytes gives. Output: F (B, n_docs) i32.
int bitfilter_batched(const uint32_t* bits, const int32_t* codes,
                      const int32_t* doc_lens, int B, int n_c, int n_docs,
                      int cap, void* scratch, int32_t* F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* bitsT = static_cast<uint32_t*>(scratch);
  uint32_t* occ = bitsT + (size_t)n_c * B;
  bitfilter_rows_kernel<<<(n_c + 31) / 32, ROWS_THREADS, 0, st>>>(
      bits, B, n_c, bitsT, occ);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // F starts at 0; the score pass writes only a group's rows holding a
  // nonzero F
  if ((err = cudaMemsetAsync(F, 0, (size_t)B * n_docs * sizeof(int32_t),
                             st)) != cudaSuccess)
    return err;
  if (cap == 0) return cudaSuccess;
  // 16-byte copies when every lane's four codes are one doc's and aligned
  if (cap % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    return launch_score_vec<4>(codes, doc_lens, bitsT, occ, B, n_c, n_docs,
                               cap, F, st);
  return launch_score_vec<1>(codes, doc_lens, bitsT, occ, B, n_c, n_docs, cap,
                             F, st);
}

// Compact mode. All pointers are device pointers. bits (B, n_c) u32;
// codes (B, n_docs, cap) i32 and lens (B, n_docs) i32, query b's candidate
// buffer. Output: F (B, n_docs) i32.
int bitfilter_query(const uint32_t* bits, const int32_t* codes,
                    const int32_t* lens, int B, int n_c, int n_docs, int cap,
                    int32_t* F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bitfilter_query_kernel<<<dim3((n_docs + SCORE_WARPS - 1) / SCORE_WARPS, B),
                           SCORE_WARPS * 32, 0, st>>>(bits, codes, lens, n_c,
                                                      n_docs, cap, F);
  return cudaGetLastError();
}

}  // extern "C"
