// Fused EMVB phases 1b-2 for a micro-batch of queries sharing one corpus
// (score_all mode): stacked bit vectors, Eq. 4 filter scores, and the exact
// top-n_filter by the unique key (f + 1) << 25 | (2^25 - 1 - doc_id).
//
// Replaces: repro/kernels/prefilter.py::prefilter_batched (Pallas body
// _prefilter_batched_kernel, prefilter.py:106) and, at B = 1,
// prefilter.py::prefilter (_prefilter_kernel, :62).
//
// What bounds it on the H100: bytes, and then the latency of Eq. 4's
// gathers. It must read the CS (B x n_q x n_c fp32, 1.07 GB at B = 32 and
// n_c = 2^18), the candidate bitmap (B x n_docs bytes, 0.28 GB), and the
// lengths and codes of every doc that is some query's candidate, and write
// the bit table: about 2.3 GB, 0.7 ms at 3.35 TB/s at B = 32 on the
// emvb-msmarco funnel (chip_smoke.py computes the bound from the run's own
// candidates). Beyond bytes, Eq. 4 gathers one 4-byte word per (valid
// token, candidate query) pair: random reads of the 1 MiB-per-query word
// table, which only L2 (50 MB) holds, so each costs a 32-byte sector and an
// L2 round trip.
//
// What the design does about it:
//  * Pass `pack` reads the CS with 16-byte loads, four float32 or eight bf16
//    columns a thread, and stores `bits` (B, n_c) in 16-byte stores. CS is
//    float32 or bf16 (pack_kernel<T>): the reference compares in the CS
//    dtype against th cast to it (prefilter.py:76, :118), so th comes
//    rounded to that type and a bf16 entry is widened before the compare.
//    Every pass after the pack sees only words. In bf16 the pack reads half
//    the bytes. When B >= DENSE_MIN, pass
//    `transpose` copies it to bitsT (n_c, B), one token's words in one row
//    (emvb::transpose_words, as bitfilter.cu; ~64 MB moved at B = 32).
//  * Pass `score` takes a tile of TILE docs per block. It builds each doc's
//    mask of candidate queries from the bitmap, lists the tile's docs that
//    are some query's candidate, and reads only their codes. A warp takes
//    one listed doc at a time, in one of two forms chosen by the doc's
//    count of candidate queries:
//    - sparse, fewer than DENSE_MIN: 32 tokens across the lanes (one
//      coalesced 128-byte read a round), and for each query in the doc's
//      mask every lane gathers its token's word from `bits` and the warp
//      ORs them (emvb::chunk_word_or, two queries at once): work in
//      proportion to the (candidate doc, candidate query) pairs, with all
//      32 lanes busy. The next doc's codes are copied into shared memory
//      with cp.async while this doc's gathers are in flight. Lane b keeps
//      query b's word across a doc's chunks, so a doc longer than CHUNK
//      tokens adds chunks, not state.
//    - dense, DENSE_MIN or more: bitfilter.cu's form (emvb::doc_word_or),
//      lane b walking the doc's tokens for query b over the rows of bitsT,
//      a warp reading one 128-byte row a token at B = 32: a fixed cost a
//      token whatever the doc's candidate queries. The dense docs run after
//      the sparse ones, in a loop of their own, so the sparse loop carries
//      no branch for them.
//    On the emvb-msmarco funnel almost every doc takes the sparse form; on
//    a batch of near-duplicate queries most take the dense one. DENSE_MIN
//    is where the dense form overtook the sparse one on the planted
//    emvb-msmarco index at B = 32, in a sweep of the constant on the card;
//    chip_smoke.py's limits phase times docs on both sides of it (16 and
//    24 candidate queries).
//  * Selection needs no running merge and no sort: the keys are unique, so
//    any exact selection equals lax.top_k's, and F takes 34 values (-1..32),
//    so a selected doc's rank is a sum of counts: the docs in higher bins,
//    plus the docs of its bin in earlier tiles, plus those before it in its
//    tile. The score pass adds each tile's histogram to corpus totals per
//    (query, bin), which give the threshold f*, and stores per (query, bin,
//    tile) the tile's docs at bin >= x. Pass `bin_rank` (a block per (bin,
//    query), the bins at or above f*'s) scans each bin's tile counts into
//    the rank of the tile's first doc of that bin; pass `place` walks the
//    tiles that hold a selected doc, only their 32-doc runs holding one,
//    ranks a doc among its run's docs of its bin with __match_any_sync, and
//    writes (f, id) straight into its slot. Any n_filter up to the whole
//    corpus takes the same two passes (fig2's no-prefilter baseline keeps
//    all 8,841,823 docs). An earlier form sorted the selected keys in one
//    block's shared memory, which capped n_filter at 8,192 and was no
//    faster from n_filter 1,024 to 8,192 (PERF.md, row 1d).
//    Only F (B x n_docs int8, rows padded to whole tiles) goes through
//    device memory between the passes.
//  * The column pack and a doc's word OR are the functions of doc_math.cuh
//    that the unfused bitpack.cu and bitfilter.cu also build on.
//
// Filtered retrieval (score_all mode with a plan): the reference ANDs a
// static DNF plan's verdict on each doc's predicate word into the bitmap
// inside the kernel (prefilter.py:129-132). Here `score` reads a doc's
// word only when the plan is given, while it builds the doc's mask of
// candidate queries, and clears the mask when no clause (required,
// forbidden) holds: a filtered doc costs one 4-byte read and is never
// scored. The clauses are a small device array read through the cache; an
// empty plan passes nothing and the clause (0, 0) everything.
//
// Compact mode (per-query candidate codes (B, cand_cap, cap), the
// reference's prefilter.py:141-145): ids are buffer positions, and only
// pass `score_query` differs, a warp per (query, buffer slot) walking the
// slot's tokens over query b's row of `bits`, 128 tokens a round with all
// four gathers of a lane in flight. The cut passes run unchanged on its F,
// so ties break on buffer position as in score_all mode. The buffer holds
// a few thousand docs a query (4096 in chip_smoke.py), so this simple form
// is not where the time goes.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int ID_BITS = 25;
constexpr int MAX_ID = (1 << ID_BITS) - 1;
constexpr int NBINS = 34;             // f + 1 in [0, 33]
constexpr int TILE = 1024;            // docs per score block and per tile
constexpr int SCORE_THREADS = 256;    // 8 warps; 4 docs a thread in the list
constexpr int CHUNK = 128;            // tokens a warp stages per step
constexpr int ROUNDS = CHUNK / 32;
constexpr int PACK_THREADS = 256;
constexpr int PLACE_WARPS = 8;        // place: warps a block
constexpr int PLACE_TILES = 8;        // tiles a place warp checks, at most
constexpr int SCAN_THREADS = 1024;    // bin_rank: a block per (bin, query)
constexpr int QSCORE_THREADS = 1024;  // score_query: 32 warps, 32 slots each
constexpr int DENSE_MIN = 20;         // candidate queries for the dense form
static_assert(TILE == 4 * SCORE_THREADS, "score lists 4 docs a thread");
static_assert(TILE == 32 * 32, "place gives each lane 32 docs of a tile");

constexpr size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

// The scratch the passes share, carved from one allocation.
struct Scratch {
  int8_t* F;          // (B, n_tiles * TILE): F, -1 off the bitmap, -2 pads
  int32_t* tot;       // (B, NBINS) docs per bin over the corpus
  int32_t* cum;       // (B, NBINS, n_tiles) a tile's docs at bin >= x
  int32_t* rk;        // (B, NBINS, n_tiles) rank of a tile's first doc of
                      // bin x, for the bins at or above f* + 1
  int32_t* fbin;      // (B) the threshold bin f* + 1
  uint32_t* bitsT;    // (n_c, B) the transposed words; null below DENSE_MIN
};

size_t carve(void* base, int B, int n_c, int n_docs, int per_query,
             Scratch* s) {
  const size_t n_tiles = (n_docs + TILE - 1) / TILE;
  const size_t sizes[6] = {
      (size_t)B * n_tiles * TILE, (size_t)B * NBINS * 4,
      (size_t)B * NBINS * n_tiles * 4, (size_t)B * NBINS * n_tiles * 4,
      (size_t)B * 4,
      B >= DENSE_MIN && !per_query ? (size_t)n_c * B * 4 : 0};
  char* p = static_cast<char*>(base);
  size_t off[6], total = 0;
  for (int i = 0; i < 6; ++i) {
    off[i] = total;
    total += align256(sizes[i]);
  }
  if (s != nullptr) {
    s->F = reinterpret_cast<int8_t*>(p + off[0]);
    s->tot = reinterpret_cast<int32_t*>(p + off[1]);
    s->cum = reinterpret_cast<int32_t*>(p + off[2]);
    s->rk = reinterpret_cast<int32_t*>(p + off[3]);
    s->fbin = reinterpret_cast<int32_t*>(p + off[4]);
    s->bitsT = sizes[5] ? reinterpret_cast<uint32_t*>(p + off[5]) : nullptr;
  }
  return total;
}

// Whether a predicate word passes a plan: some clause (required, forbidden)
// has (w & required) == required and (w & forbidden) == 0.
__device__ __forceinline__ bool plan_pass(uint32_t w,
                                          const uint32_t* __restrict__ clauses,
                                          int n_clauses) {
  for (int i = 0; i < n_clauses; ++i) {
    const uint32_t req = __ldg(clauses + 2 * i);
    const uint32_t forb = __ldg(clauses + 2 * i + 1);
    if ((w & req) == req && (w & forb) == 0u) return true;
  }
  return false;
}

// Pass 1: bits (B, n_c), and zeros in the bin totals the score pass adds
// to. grid (ceil(n_c / (V * PACK_THREADS)), B); thread = V = Cs<T>::kVec
// neighbouring columns, 16 bytes of CS a term (16-byte loads and stores
// when `vec`).
template <typename T>
__global__ void pack_kernel(const T* __restrict__ cs, float th,
                            const uint8_t* __restrict__ qmask, int n_q,
                            int n_c, int vec, uint32_t* __restrict__ bits,
                            int32_t* __restrict__ tot) {
  constexpr int V = emvb::Cs<T>::kVec;
  const int b = blockIdx.y;
  if (blockIdx.x == 0 && threadIdx.x < NBINS) tot[b * NBINS + threadIdx.x] = 0;
  const int c0 = V * (blockIdx.x * blockDim.x + threadIdx.x);
  if (c0 >= n_c) return;
  const uint32_t live = emvb::live_terms(emvb::mask_row(qmask, b, n_q), n_q);
  const T* col = cs + (size_t)b * n_q * n_c + c0;
  uint32_t* out = bits + (size_t)b * n_c + c0;
  if (vec) {
    uint32_t w[V];
    emvb::pack_columns(col, n_c, th, live, n_q, w);
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<uint4*>(out + j) =
          make_uint4(w[j], w[j + 1], w[j + 2], w[j + 3]);
  } else {
    for (int j = 0; j < V && c0 + j < n_c; ++j)
      out[j] = emvb::pack_column(col + j, n_c, th, live, n_q);
  }
}

// Pass 1 on CS of T; `vec` when its rows are 16-byte aligned.
template <typename T>
cudaError_t launch_pack(const T* cs, float th, const uint8_t* qmask, int B,
                        int n_q, int n_c, uint32_t* bits, int32_t* tot,
                        cudaStream_t st) {
  constexpr int V = emvb::Cs<T>::kVec;
  const int vec =
      (n_c % V == 0) && (reinterpret_cast<uintptr_t>(cs) % 16 == 0);
  const int groups = (n_c + V - 1) / V;
  pack_kernel<T><<<dim3((groups + PACK_THREADS - 1) / PACK_THREADS, B),
                   PACK_THREADS, 0, st>>>(cs, th, qmask, n_q, n_c, vec, bits,
                                          tot);
  return cudaGetLastError();
}

// Pass 1b, B >= DENSE_MIN only: bitsT (n_c, B) from bits. grid
// ceil(n_c / 32), 256 threads.
__global__ void transpose_kernel(const uint32_t* __restrict__ bits, int B,
                                 int n_c, uint32_t* __restrict__ bitsT) {
  emvb::transpose_words(bits, B, n_c, bitsT);
}

// Pass 2: F for every (query, doc) of one tile, and its histogram. With a
// plan (pred not null), a doc whose predicate word fails it is no query's
// candidate. grid n_tiles. Shared: sF[B][TILE] i8, smask[TILE] u32 (bit b: the doc is
// query b's candidate), slist[TILE] u16 (the docs with a mask: the sparse
// form's from the front, the dense form's from the back), sh[B][NBINS], and
// two CHUNK-token code buffers per warp.
__global__ void __launch_bounds__(SCORE_THREADS)
score_kernel(const int32_t* __restrict__ codes,
             const int32_t* __restrict__ doc_lens,
             const uint8_t* __restrict__ bitmap,
             const uint32_t* __restrict__ pred,
             const uint32_t* __restrict__ clauses, int n_clauses,
             const uint32_t* __restrict__ bits,
             const uint32_t* __restrict__ bitsT, int B, int n_c,
             int n_docs, int cap, int n_tiles, int8_t* __restrict__ F,
             int32_t* __restrict__ tot, int32_t* __restrict__ cum) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sF = reinterpret_cast<int8_t*>(smem);
  uint32_t* smask = reinterpret_cast<uint32_t*>(smem + B * TILE);
  int* sh = reinterpret_cast<int*>(smask + TILE);
  int* sbuf = sh + ((B * NBINS + 3) & ~3);
  uint16_t* slist = reinterpret_cast<uint16_t*>(
      sbuf + (blockDim.x >> 5) * 2 * CHUNK);
  __shared__ int sw[32];
  __shared__ int s_nsparse, s_ndense;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const size_t d0 = (size_t)tile * TILE;
  const int n_valid = min(TILE, n_docs - tile * TILE);

  // F starts at -1 (no query's candidate) and -2 past the corpus' end.
  for (int j = tid; j < B * TILE / 4; j += blockDim.x)
    reinterpret_cast<uint32_t*>(sF)[j] = 0xffffffffu;
  for (int j = tid; j < B * NBINS; j += blockDim.x) sh[j] = 0;
  {
    // docs tid + k * SCORE_THREADS: each (query, k) read is a warp's 32
    // neighbouring bytes, and all of a thread's reads are in flight at once
    uint32_t m[TILE / SCORE_THREADS] = {};
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      const uint8_t* row = bitmap + (size_t)b * n_docs + d0;
#pragma unroll
      for (int k = 0; k < TILE / SCORE_THREADS; ++k) {
        const int t = tid + k * SCORE_THREADS;
        if (t < n_valid) m[k] |= (uint32_t)(row[t] != 0) << b;
      }
    }
    if (pred != nullptr) {
#pragma unroll
      for (int k = 0; k < TILE / SCORE_THREADS; ++k) {
        const int t = tid + k * SCORE_THREADS;
        if (m[k] && !plan_pass(pred[d0 + t], clauses, n_clauses)) m[k] = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < TILE / SCORE_THREADS; ++k)
      smask[tid + k * SCORE_THREADS] = m[k];
  }
  __syncthreads();
  if (n_valid < TILE)
    for (int j = tid; j < B * TILE; j += blockDim.x)
      if (j % TILE >= n_valid) sF[j] = -2;

  // The lists of candidate docs: thread i owns docs 4i..4i+3, and one scan
  // counts both lists (sparse in the low 16 bits, dense in the high).
  auto dense = [&](uint32_t m) {
    return bitsT != nullptr && __popc(m) >= DENSE_MIN;
  };
  {
    int own = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = smask[4 * tid + k];
      if (m) own += dense(m) ? 1 << 16 : 1;
    }
    int total;
    const int at = block_excl_scan(own, sw, &total);
    int as = at & 0xffff, ad = at >> 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = smask[4 * tid + k];
      if (m == 0) continue;
      if (dense(m))
        slist[TILE - 1 - ad++] = (uint16_t)(4 * tid + k);
      else
        slist[as++] = (uint16_t)(4 * tid + k);
    }
    if (tid == 0) {
      s_nsparse = total & 0xffff;
      s_ndense = total >> 16;
    }
  }
  __syncthreads();

  // Sparse form: each warp walks its docs of the list in (doc, chunk)
  // steps; step i + 1's codes are copied while step i gathers.
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int nsparse = s_nsparse;
  const int n_ch = (cap + CHUNK - 1) / CHUNK;
  const int n_steps =
      nsparse > warp ? (nsparse - warp + nwarps - 1) / nwarps * n_ch : 0;
  int* buf = sbuf + warp * 2 * CHUNK;
  auto copy_step = [&](int i) {
    const int t = slist[warp + (i / n_ch) * nwarps];
    const int lo = (i % n_ch) * CHUNK, hi = min(cap, lo + CHUNK);
    const int32_t* src = codes + (d0 + t) * cap;
    int* dst = buf + (i & 1) * CHUNK;
    for (int tok = lo + lane; tok < hi; tok += 32)
      cp_async4(dst + (tok - lo), src + tok);
    cp_async_commit();
  };
  if (n_steps > 0) copy_step(0);
  int len_next = n_steps > 0 ? doc_lens[d0 + slist[warp]] : 0;
  int len = 0;
  uint32_t word = 0;          // lane b: query b's OR over the doc so far
  for (int i = 0; i < n_steps; ++i) {
    const int k = warp + (i / n_ch) * nwarps;
    const int ch = i % n_ch;
    const int t = slist[k];
    if (ch == 0) {
      len = min(max(len_next, 0), cap);
      if (k + nwarps < nsparse) len_next = doc_lens[d0 + slist[k + nwarps]];
    }
    if (i + 1 < n_steps) copy_step(i + 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int* cur = buf + (i & 1) * CHUNK;
    const int lo = ch * CHUNK;
    int c[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int tok = lo + r * 32 + lane;
      c[r] = tok < len ? min(max(cur[r * 32 + lane], 0), n_c - 1) : -1;
    }
    const uint32_t mask = smask[t];
    uint32_t mq = mask;
    while (mq) {                       // warp-uniform
      const int b1 = __ffs(mq) - 1;
      mq &= mq - 1;
      int b2 = -1;
      if (mq) {
        b2 = __ffs(mq) - 1;
        mq &= mq - 1;
      }
      uint32_t a1, a2;
      emvb::chunk_word_or<ROUNDS>(
          bits + (size_t)b1 * n_c,
          b2 >= 0 ? bits + (size_t)b2 * n_c : nullptr, c, &a1, &a2);
      if (lane == b1) word |= a1;
      if (lane == b2) word |= a2;
    }
    if (ch == n_ch - 1) {
      if ((mask >> lane) & 1u) {
        const int f = __popc(word);
        sF[lane * TILE + t] = (int8_t)f;
        atomicAdd(&sh[lane * NBINS + f + 1], 1);
      }
      word = 0;
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // Dense form: each warp takes its docs of the list's back, lanes split
  // into (token group g, query bq) pairs as in bitfilter.cu.
  const int Q = next_pow2(B), G = 32 / Q, bq = lane % Q, g = lane / Q;
  for (int k = warp; k < s_ndense; k += nwarps) {
    const int t = slist[TILE - 1 - k];
    const int len = min(max(doc_lens[d0 + t], 0), cap);
    word = emvb::doc_word_or(codes + (d0 + t) * cap, len, n_c, bitsT, B, bq,
                             g, G, Q, bq < B);
    if (g == 0 && ((smask[t] >> bq) & 1u)) {
      const int f = __popc(word);
      sF[bq * TILE + t] = (int8_t)f;
      atomicAdd(&sh[bq * NBINS + f + 1], 1);
    }
  }
  __syncthreads();

  // Bin 0 counts the valid docs that are not the query's candidate. Thread
  // b adds query b's counts to the corpus totals and turns them into the
  // tile's counts at bin >= x, which is what bin_rank and place read.
  if (tid < B) {
    int* hb = sh + tid * NBINS;
    int cand = 0;
    for (int bin = 1; bin < NBINS; ++bin) cand += hb[bin];
    hb[0] = n_valid - cand;
    int at_or_above = 0;
    for (int bin = NBINS - 1; bin >= 0; --bin) {
      if (hb[bin]) atomicAdd(&tot[tid * NBINS + bin], hb[bin]);
      at_or_above += hb[bin];
      hb[bin] = at_or_above;
    }
  }
  __syncthreads();
  const size_t stride = (size_t)n_tiles * TILE;
  for (int j = tid; j < B * TILE / 4; j += blockDim.x) {
    const int b = j / (TILE / 4), w = j % (TILE / 4);
    reinterpret_cast<uint32_t*>(F + (size_t)b * stride + d0)[w] =
        reinterpret_cast<const uint32_t*>(sF)[j];
  }
  for (int j = tid; j < B * NBINS; j += blockDim.x)
    cum[(size_t)j * n_tiles + tile] = sh[j];
}

// Pass 2, compact mode: F of every (query, buffer slot) of one tile of
// query b's buffer, and its histogram, as `score` leaves them. grid
// (n_tiles, B), QSCORE_THREADS threads; a warp per slot whose bitmap bit is
// set (and whose predicate word passes the plan, when one is given).
__global__ void __launch_bounds__(QSCORE_THREADS)
score_query_kernel(const int32_t* __restrict__ codes,
                   const int32_t* __restrict__ lens,
                   const uint8_t* __restrict__ bitmap,
                   const uint32_t* __restrict__ pred,
                   const uint32_t* __restrict__ clauses, int n_clauses,
                   const uint32_t* __restrict__ bits, int n_c, int n_docs,
                   int cap, int n_tiles, int8_t* __restrict__ F,
                   int32_t* __restrict__ tot, int32_t* __restrict__ cum) {
  __shared__ __align__(16) int8_t sF[TILE];
  __shared__ int sh[NBINS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile = blockIdx.x, b = blockIdx.y;
  const size_t d0 = (size_t)tile * TILE;
  const int n_valid = min(TILE, n_docs - tile * TILE);
  for (int j = tid; j < TILE; j += blockDim.x) sF[j] = j < n_valid ? -1 : -2;
  if (tid < NBINS) sh[tid] = 0;
  __syncthreads();
  const uint32_t* wb = bits + (size_t)b * n_c;
  const size_t row0 = (size_t)b * n_docs + d0;
  for (int t = warp; t < n_valid; t += nwarps) {
    bool cand = bitmap[row0 + t] != 0;
    if (cand && pred != nullptr)
      cand = plan_pass(pred[d0 + t], clauses, n_clauses);
    if (!cand) continue;                             // warp-uniform
    const int len = min(max(lens[row0 + t], 0), cap);
    const int32_t* cd = codes + (row0 + t) * cap;
    uint32_t w = 0;
    for (int base = 0; base < len; base += ROUNDS * 32) {
      int c[ROUNDS];
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int tok = base + r * 32 + lane;
        c[r] = tok < len ? min(max(cd[tok], 0), n_c - 1) : -1;
      }
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r)
        if (c[r] >= 0) w |= wb[c[r]];
    }
    w = __reduce_or_sync(FULL_MASK, w);
    if (lane == 0) {
      const int f = __popc(w);
      sF[t] = (int8_t)f;
      atomicAdd(&sh[f + 1], 1);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int cand = 0;
    for (int bin = 1; bin < NBINS; ++bin) cand += sh[bin];
    sh[0] = n_valid - cand;
    int at_or_above = 0;
    for (int bin = NBINS - 1; bin >= 0; --bin) {
      if (sh[bin]) atomicAdd(&tot[b * NBINS + bin], sh[bin]);
      at_or_above += sh[bin];
      sh[bin] = at_or_above;
    }
  }
  __syncthreads();
  uint32_t* Fb = reinterpret_cast<uint32_t*>(F + (size_t)b * n_tiles * TILE +
                                             d0);
  for (int j = tid; j < TILE / 4; j += blockDim.x)
    Fb[j] = reinterpret_cast<const uint32_t*>(sF)[j];
  if (tid < NBINS) cum[((size_t)b * NBINS + tid) * n_tiles + tile] = sh[tid];
}

// The threshold bin f* + 1 of a query from its bin totals tb (read by
// every thread): the highest bin at which the docs at or above it reach
// n_filter.
__device__ __forceinline__ int threshold_bin(const int32_t* tb,
                                             int n_filter) {
  int cum_hi = 0, bin = NBINS - 1;
  for (; bin > 0; --bin) {
    if (cum_hi + tb[bin] >= n_filter) break;
    cum_hi += tb[bin];
  }
  return bin;
}

// Pass 3: block (x, b) for a bin x at or above query b's
// threshold bin writes, per tile in ascending order, the rank of the tile's
// first doc at bin x: the docs in bins above x over the corpus plus the
// docs at x in the tiles before (a bin no doc is in is skipped: no rank of
// it is read). The threshold bin's block writes fbin[b] = f* + 1. grid
// (NBINS, B).
__global__ void __launch_bounds__(SCAN_THREADS)
bin_rank_kernel(const int32_t* __restrict__ tot,
                const int32_t* __restrict__ cum, int n_tiles, int n_filter,
                int32_t* __restrict__ rk, int32_t* __restrict__ fbins) {
  __shared__ int sw[32];
  const int x = blockIdx.x, b = blockIdx.y;
  const int32_t* tb = tot + b * NBINS;
  const int fbin = threshold_bin(tb, n_filter);
  if (x < fbin || (x > fbin && tb[x] == 0)) return;   // block-uniform
  int base = 0;
  for (int y = x + 1; y < NBINS; ++y) base += tb[y];
  if (x == fbin && threadIdx.x == 0) fbins[b] = fbin;
  const int32_t* at_x = cum + ((size_t)b * NBINS + x) * n_tiles;
  const int32_t* above_x = x + 1 < NBINS ? at_x + n_tiles : nullptr;
  int32_t* out = rk + ((size_t)b * NBINS + x) * n_tiles;
  // blockDim.x tiles a step, thread t tile t of the step (coalesced reads
  // and writes), the step's scan carried into the next
  for (int t0 = 0; t0 < n_tiles; t0 += blockDim.x) {
    const int tl = t0 + threadIdx.x;
    const int c = tl < n_tiles ? at_x[tl] - (above_x ? above_x[tl] : 0) : 0;
    int total;
    const int r = block_excl_scan(c, sw, &total);
    if (tl < n_tiles) out[tl] = base + r;
    base += total;
  }
}

// Pass 4: every selected doc's (f, id) written straight into
// its rank. A warp takes `per_warp` (at most 32) neighbouring tiles of one
// query and walks those that hold a doc above f* or a doc at f* ranked below
// n_filter: it copies the tile's F to shared memory, lane l reading docs
// 32l..32l+31, and visits only the runs of 32 docs holding one at or above
// f*, in ascending order, lane j doc j of the run; a doc's rank is its
// tile's first rank of its bin (kept per warp in shared memory, advanced
// after each run) plus the lanes below it in the run with its bin
// (__match_any_sync). grid (ceil(n_tiles / (PLACE_WARPS * per_warp)), B).
__global__ void __launch_bounds__(PLACE_WARPS * 32)
place_kernel(const int8_t* __restrict__ F, const int32_t* __restrict__ cum,
             int n_tiles, int n_filter, int per_warp,
             const int32_t* __restrict__ rk,
             const int32_t* __restrict__ fbins, int32_t* __restrict__ scores,
             int32_t* __restrict__ ids) {
  __shared__ int first_rank[PLACE_WARPS][NBINS];
  __shared__ __align__(16) int8_t tile_f[PLACE_WARPS][TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * PLACE_WARPS + warp) * per_warp;
  const int b = blockIdx.y;
  if (first >= n_tiles) return;                       // warp-uniform
  const int fbin = fbins[b];
  const int32_t* cb = cum + (size_t)b * NBINS * n_tiles;
  const int32_t* rb = rk + (size_t)b * NBINS * n_tiles;
  bool busy = false;
  if (lane < per_warp && first + lane < n_tiles) {
    const int tile = first + lane;
    const int ge = cb[(size_t)fbin * n_tiles + tile];
    const int gt = fbin + 1 < NBINS ? cb[(size_t)(fbin + 1) * n_tiles + tile]
                                    : 0;
    busy = gt > 0 || (ge > gt && rb[(size_t)fbin * n_tiles + tile] < n_filter);
  }
  int* nx = first_rank[warp];
  int8_t* tf = tile_f[warp];
  int32_t* sb = scores + (size_t)b * n_filter;
  int32_t* ib = ids + (size_t)b * n_filter;
  for (uint32_t todo = __ballot_sync(FULL_MASK, busy); todo;
       todo &= todo - 1) {
    const int tile = first + __ffs(todo) - 1;
    for (int x = fbin + lane; x < NBINS; x += 32)
      nx[x] = rb[(size_t)x * n_tiles + tile];
    // lane l copies docs 32l..32l+31 of the tile to the warp's shared copy
    // and says whether one of them is at or above the threshold bin
    union {
      uint4 u[2];
      int8_t f[32];
    } run;
    const uint4* src = reinterpret_cast<const uint4*>(
        F + (size_t)b * n_tiles * TILE + (size_t)tile * TILE + lane * 32);
    run.u[0] = src[0];
    run.u[1] = src[1];
    reinterpret_cast<uint4*>(tf + lane * 32)[0] = run.u[0];
    reinterpret_cast<uint4*>(tf + lane * 32)[1] = run.u[1];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 32; ++k) any |= run.f[k] + 1 >= fbin;
    __syncwarp();
    // the runs of 32 docs that hold one, in ascending order, lane j doc j
    for (uint32_t runs = __ballot_sync(FULL_MASK, any); runs;
         runs &= runs - 1) {
      const int d0 = 32 * (__ffs(runs) - 1);
      const int x = tf[d0 + lane] + 1;                // -1 on a pad
      const bool mine = x >= fbin;
      const uint32_t act = __ballot_sync(FULL_MASK, mine);
      uint32_t same = 0u;
      int r = 0;
      if (mine) {
        same = __match_any_sync(act, x);
        r = nx[x] + __popc(same & ((1u << lane) - 1u));
      }
      __syncwarp();
      if (mine) {
        if (r < n_filter) {
          sb[r] = x - 1;
          ib[r] = tile * TILE + d0 + lane;
        }
        if (lane == 31 - __clz(same)) nx[x] += __popc(same);
      }
      __syncwarp();
    }
  }
}

// Passes 3-4 on the score pass's F, histogram and tile counts: each bin's
// tile ranks, then every selected doc placed at its rank.
int select_keys(const Scratch& s, int B, int n_tiles, int n_filter,
                int32_t* scores, int32_t* ids, cudaStream_t st) {
  cudaError_t err;
  // Several tiles a warp only where the (tile, query) pairs are many enough
  // to fill the card (64 warps an SM) twice over: 8 at B = 32, 1 at B = 1
  // on emvb-msmarco.
  const int per_warp = max(1, min(PLACE_TILES, (int)((size_t)B * n_tiles /
                                                       (128 * sm_count()))));
  const int per_block = PLACE_WARPS * per_warp;
  bin_rank_kernel<<<dim3(NBINS, B), SCAN_THREADS, 0, st>>>(
      s.tot, s.cum, n_tiles, n_filter, s.rk, s.fbin);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  place_kernel<<<dim3((n_tiles + per_block - 1) / per_block, B),
                 PLACE_WARPS * 32, 0, st>>>(s.F, s.cum, n_tiles, n_filter,
                                              per_warp, s.rk, s.fbin, scores,
                                              ids);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of device scratch prefilter_batched needs.
size_t prefilter_scratch_bytes(int B, int n_c, int n_docs, int per_query) {
  return carve(nullptr, B, n_c, n_docs, per_query, nullptr);
}

// All pointers are device pointers; qmask may be null (every term live).
// cs (B, n_q, n_c) f32, or bf16 when cs_bf16; th rounded to the CS type;
// qmask (B, n_q) u8; codes (n_docs, cap) i32 and doc_lens (n_docs,) i32, or
// per_query: codes (B, n_docs, cap) and doc_lens (B, n_docs); bitmap
// (B, n_docs) u8; B <= 32. pred (n_docs,) u32 predicate
// words, or null for no plan; clauses (n_clauses, 2) u32 (required,
// forbidden); 1 <= n_filter <= n_docs. Outputs: bits (B, n_c) u32,
// scores/ids (B, n_filter) i32. scratch: the bytes prefilter_scratch_bytes
// gives, 256-byte aligned.
int prefilter_batched(const void* cs, int cs_bf16, float th,
                      const uint8_t* qmask, const int32_t* codes,
                      const int32_t* doc_lens,
                      const uint8_t* bitmap, int B, int n_q, int n_c,
                      int n_docs, int cap, int n_filter, int per_query,
                      const uint32_t* pred, const uint32_t* clauses,
                      int n_clauses, uint32_t* bits, int32_t* scores,
                      int32_t* ids, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n_docs + TILE - 1) / TILE;
  Scratch s;
  carve(scratch, B, n_c, n_docs, per_query, &s);
  cudaError_t err = with_cs(cs, cs_bf16, [&](auto p) {
    return launch_pack(p, th, qmask, B, n_q, n_c, bits, s.tot, st);
  });
  if (err != cudaSuccess) return err;
  if (per_query) {
    score_query_kernel<<<dim3(n_tiles, B), QSCORE_THREADS, 0, st>>>(
        codes, doc_lens, bitmap, pred, clauses, n_clauses, bits, n_c, n_docs,
        cap, n_tiles, s.F, s.tot, s.cum);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return select_keys(s, B, n_tiles, n_filter, scores, ids, st);
  }
  if (s.bitsT != nullptr) {
    transpose_kernel<<<(n_c + 31) / 32, 256, 0, st>>>(bits, B, n_c, s.bitsT);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = (size_t)B * TILE + TILE * 4 +
                      ((B * NBINS + 3) & ~3) * 4 +
                      (SCORE_THREADS / 32) * 2 * CHUNK * 4 + TILE * 2;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(score_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  score_kernel<<<n_tiles, SCORE_THREADS, smem, st>>>(
      codes, doc_lens, bitmap, pred, clauses, n_clauses, bits, s.bitsT, B,
      n_c, n_docs, cap, n_tiles, s.F, s.tot, s.cum);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return select_keys(s, B, n_tiles, n_filter, scores, ids, st);
}

}  // extern "C"

