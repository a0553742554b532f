// Device helpers shared by the kernels: block-wide exclusive scan, a warp
// exclusive scan, the cuts (each of n unique keys to its rank), order-
// preserving float bits, cp.async (plain and zero-filling), and Hopper's
// mbarriers and bulk copies.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr unsigned FULL_MASK = 0xffffffffu;

// Centroid scores (CS) come as float32 or bf16: the C entries that read them
// take `const void*` and a `cs_bf16` flag (the Python wrappers'
// _build.cs_flag). with_cs calls f with the pointer cast to its element type
// and returns what f returns; f is a generic lambda that launches the
// passes templated on that type.
template <typename F>
inline auto with_cs(const void* cs, int cs_bf16, F&& f) {
  if (cs_bf16) return f(static_cast<const __nv_bfloat16*>(cs));
  return f(static_cast<const float*>(cs));
}

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Exclusive prefix sum of one int per thread across the block (blockDim.x a
// multiple of 32, at most 1024). `sw` is 32 ints of shared scratch; the
// block total lands in *total. Every thread of the block must call it.
__device__ __forceinline__ int block_excl_scan(int v, int* sw, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sw[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? sw[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    sw[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (w > 0 ? sw[w - 1] : 0);
  *total = sw[nw - 1];
  __syncthreads();
  return excl;
}

// Exclusive prefix sum of one int per lane across the warp; all 32 lanes.
__device__ __forceinline__ int warp_excl_scan(int v) {
  const int lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  return x - v;
}

// Position of `key` in the descending order of s[0..n): the number of keys
// above it. SPLIT neighbouring lanes (a power of two, at most 32) share one
// key, lane `part` counting over s[part], s[part + SPLIT], ... (neighbouring
// words, so the SPLIT reads of a step hit different banks); every lane of
// the group gets the total. All 32 lanes of the warp must call it.
template <int SPLIT, typename T>
__device__ __forceinline__ int rank_desc(const T* s, int n, T key, int part) {
  int r = 0;
#pragma unroll 8
  for (int j = part; j < n; j += SPLIT) r += s[j] > key;
#pragma unroll
  for (int o = 1; o < SPLIT; o <<= 1) r += __shfl_xor_sync(FULL_MASK, r, o);
  return r;
}

// Sort s[0..n) descending, n a power of two, all threads of the block.
template <typename T>
__device__ void bitonic_sort_desc(T* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const T a = s[i], c = s[ixj];
          const bool desc = (i & k) == 0;
          if (desc ? (a < c) : (a > c)) {
            s[i] = c;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// A cut: every one of a query's n unique keys goes to its rank in
// descending order, which is an exact sort. Two forms, chosen per launch by
// cut_launch:
//  * rank: grid (ceil(n / (threads / CUT_SPLIT)), B), 256 threads; every
//    block holds the query's n keys and ranks threads / CUT_SPLIT of them,
//    CUT_SPLIT lanes a key (rank_desc): n^2 compares a query, spread over
//    many blocks, no barrier chain;
//  * sort: grid (1, B), 1024 threads, the keys padded to P = next_pow2(n)
//    with keys below every real one; one block sorts them (bitonic) and the
//    key at position r has rank r: n log^2 n compares, on one SM a query.
// Ranking wins while B x n is small (at B = 1, and at n_filter = 1024 for
// B = 32), sorting above (B = 32 at n = 4096): chip_smoke.py's limits
// phase measures both sides. s holds the P keys in shared memory; emit(key,
// rank) writes one key out.
constexpr int CUT_SPLIT = 4;
constexpr long long CUT_SORT_ABOVE = 1 << 16;   // B x n

struct CutLaunch {
  dim3 grid;
  int threads, P;
  bool sort;
};

inline CutLaunch cut_launch(int B, int n) {
  if ((long long)B * n > CUT_SORT_ABOVE)
    return {dim3(1, B), 1024, next_pow2(n), true};
  const int keys = 256 / CUT_SPLIT;
  return {dim3((n + keys - 1) / keys, B), 256, n, false};
}

template <typename T, typename Emit>
__device__ __forceinline__ void cut_keys(T* s, int n, int P, bool sort,
                                         Emit emit) {
  if (sort) {
    bitonic_sort_desc(s, P);
    for (int r = threadIdx.x; r < n; r += blockDim.x) emit(s[r], r);
    return;
  }
  const int i = blockIdx.x * (blockDim.x / CUT_SPLIT) + threadIdx.x / CUT_SPLIT;
  const int part = threadIdx.x % CUT_SPLIT;
  const T key = i < n ? s[i] : T(0);
  const int r = rank_desc<CUT_SPLIT>(s, n, key, part);
  if (i < n && part == 0) emit(key, r);
}

// A cut of any size: of a query's n unique 64-bit keys, the n_keep largest,
// each written to its rank. cut_launch's forms hold all n keys in shared
// memory, so they run while n <= CUT_SHARED_MAX; above that a cut is three
// steps over global scratch, each a kernel of its own (the __global__
// wrappers live in the .cu that launches them; the bodies are here):
//  1. select (select_pass, SELECT_PASSES launches): a radix select of the
//     n_keep-th largest key, SELECT_BITS of the key a pass from the top.
//     Each pass histograms the digit of the keys whose higher bits equal
//     the prefix found so far, over several blocks a query (shared-memory
//     bins added to the query's global bins); the last block of a query to
//     finish picks the digit that holds the key and clears the bins for
//     the next pass. When that digit's bucket holds exactly the keys still
//     wanted, the threshold is final (its lower bits zero) and the later
//     passes return at once. The keys are unique, so the last pass always
//     ends there.
//  2. compact (select_compact): the keys at or above the threshold, exactly
//     n_keep of them, to a buffer, in no order (one atomic a warp).
//  3. rank, in the form cut_launch would pick: while B x n_keep is small
//     (<= CUT_SORT_ABOVE) or the kept keys do not fit one block's opt-in
//     shared memory (P = next_pow2(n_keep) > CUT_SORT_MAX), every kept key
//     counts the kept keys above it, streamed through shared memory
//     RANK_CHUNK at a time (n_keep^2 compares a query over many blocks);
//     else one block a query sorts them (bitonic) and the key at position r
//     has rank r: 0.25 ms a cut of 10,000 keys on one SM at B = 32, where
//     the counted ranks of a B = 1 query's two cuts take 0.09 ms
//     (chip_smoke.py's limits phase, pqinter_nf20000_n_docs10000).
// The keys come from a functor key(b, i) -> the 64-bit key of element i of
// query b, and each kept key goes out through emit(b, key, rank).
constexpr int CUT_SHARED_MAX = 4096;   // keys a cut_launch form holds
constexpr int SELECT_BITS = 11;
constexpr int SELECT_BINS = 1 << SELECT_BITS;
constexpr int SELECT_PASSES = (64 + SELECT_BITS - 1) / SELECT_BITS;
constexpr int SELECT_THREADS = 256;
constexpr int SELECT_PER_THREAD = 16;  // keys a select thread takes at least
constexpr int CUT_SORT_MAX = 16384;    // 128 KiB of keys in one block
constexpr int RANK_THREADS = 256;
constexpr int RANK_CHUNK = 2048;       // keys a counting block stages a step
static_assert(SELECT_BINS % SELECT_THREADS == 0, "whole bins a thread");

// A query's select state; zero before its cut.
struct SelectState {
  unsigned long long prefix;  // the threshold's bits fixed so far
  int above;                  // keys above the prefix's bucket
  int done;                   // the threshold is final
  unsigned blocks;            // blocks of the current pass that finished
  int kept;                   // keys the compaction wrote
};

// Scratch of a cut of any size for B queries keeping n_keep keys each:
// the states, the bins and the kept keys, 256-byte aligned pieces of base
// (null: only the size). -> the bytes.
struct CutScratch {
  SelectState* state;         // (B)
  int* bins;                  // (B, SELECT_BINS)
  unsigned long long* kept;   // (B, n_keep)
};

inline size_t cut_scratch(void* base, int B, int n_keep, CutScratch* s) {
  auto up = [](size_t n) { return (n + 255) & ~size_t(255); };
  const size_t a = up((size_t)B * sizeof(SelectState));
  const size_t c = up((size_t)B * SELECT_BINS * 4);
  if (s != nullptr) {
    char* p = static_cast<char*>(base);
    *s = {reinterpret_cast<SelectState*>(p), reinterpret_cast<int*>(p + a),
          reinterpret_cast<unsigned long long*>(p + a + c)};
  }
  return a + c + up((size_t)B * n_keep * 8);
}

// Blocks a query of one select or compact launch: enough for the card at
// small B, SELECT_PER_THREAD keys a thread at least.
inline int select_blocks(int B, int n, int sms) {
  const int want = (n + SELECT_THREADS * SELECT_PER_THREAD - 1) /
                   (SELECT_THREADS * SELECT_PER_THREAD);
  const int fill = (2 * sms + B - 1) / B;
  return want < 1 ? 1 : (want < fill ? want : fill);
}

// Pass `pass` of the select; grid (select_blocks, B), SELECT_THREADS.
template <typename Key>
__device__ __forceinline__ void select_pass(Key key, int n, int n_keep,
                                            int pass, SelectState* state,
                                            int* bins) {
  __shared__ int sh[SELECT_BINS];
  __shared__ int sw[32];
  __shared__ bool s_last;
  const int b = blockIdx.y;
  SelectState* st = state + b;
  if (st->done) return;                               // block-uniform
  const int fixed = SELECT_BITS * pass;               // bits above the digit
  const int shift = fixed + SELECT_BITS < 64 ? 64 - fixed - SELECT_BITS : 0;
  const unsigned dmask = (1u << (64 - fixed - shift)) - 1u;
  const unsigned long long hi = fixed == 0 ? 0ull : ~0ull << (64 - fixed);
  const unsigned long long prefix = st->prefix;
  const int need = n_keep - st->above;                // >= 1
  for (int d = threadIdx.x; d < SELECT_BINS; d += blockDim.x) sh[d] = 0;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const unsigned long long k = key(b, i);
    if ((k & hi) == prefix) atomicAdd(&sh[(unsigned)(k >> shift) & dmask], 1);
  }
  __syncthreads();
  int* gb = bins + (size_t)b * SELECT_BINS;
  for (int d = threadIdx.x; d < SELECT_BINS; d += blockDim.x)
    if (sh[d]) atomicAdd(&gb[d], sh[d]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&st->blocks, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;                                // block-uniform
  __threadfence();
  // The last block: thread t holds digits top - PER t - j, j < PER, so one
  // scan in descending digit order finds the bucket of the need-th key.
  constexpr int PER = SELECT_BINS / SELECT_THREADS;
  int c[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = __ldcg(&gb[SELECT_BINS - 1 - PER * threadIdx.x - j]);
    sum += c[j];
  }
  int total;
  int cum = block_excl_scan(sum, sw, &total);
  if (cum < need && cum + sum >= need) {              // one thread
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (cum + c[j] >= need) {
        const unsigned d = SELECT_BINS - 1 - PER * threadIdx.x - j;
        st->prefix = prefix | ((unsigned long long)d << shift);
        st->above += cum;
        st->done = cum + c[j] == need;
        break;
      }
      cum += c[j];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) gb[SELECT_BINS - 1 - PER * threadIdx.x - j] = 0;
  if (threadIdx.x == 0) st->blocks = 0;
}

// The compaction: every key at or above the threshold to the query's kept
// buffer; grid (select_blocks, B), SELECT_THREADS.
template <typename Key>
__device__ __forceinline__ void select_compact(Key key, int n, int n_keep,
                                               SelectState* state,
                                               unsigned long long* kept) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  SelectState* st = state + b;
  const unsigned long long t = st->prefix;
  unsigned long long* out = kept + (size_t)b * n_keep;
  for (int i0 = blockIdx.x * blockDim.x; i0 < n; i0 += gridDim.x * blockDim.x) {
    const int i = i0 + threadIdx.x;
    const unsigned long long k = i < n ? key(b, i) : 0ull;
    const bool take = i < n && k >= t;
    const unsigned ball = __ballot_sync(FULL_MASK, take);
    if (ball == 0u) continue;                         // warp-uniform
    int at = 0;
    if (lane == 0) at = atomicAdd(&st->kept, __popc(ball));
    at = __shfl_sync(FULL_MASK, at, 0);
    const int pos = at + __popc(ball & ((1u << lane) - 1u));
    if (take && pos < n_keep) out[pos] = k;
  }
}

// Rank by one block's sort: grid (1, B), 1024 threads, P * 8 bytes of
// dynamic shared memory, P = next_pow2(n_keep) <= CUT_SORT_MAX.
template <typename Emit>
__device__ __forceinline__ void rank_sorted(
    const unsigned long long* __restrict__ kept, int n_keep, int P,
    Emit emit) {
  extern __shared__ unsigned long long skept[];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    skept[i] = i < n_keep ? kept[(size_t)b * n_keep + i] : 0ull;
  __syncthreads();
  bitonic_sort_desc(skept, P);
  for (int r = threadIdx.x; r < n_keep; r += blockDim.x) emit(b, skept[r], r);
}

// Rank by counting: grid (ceil(n_keep / RANK_THREADS), B), RANK_THREADS; a
// thread's key's rank is the number of kept keys above it.
template <typename Emit>
__device__ __forceinline__ void rank_counted(
    const unsigned long long* __restrict__ kept, int n_keep, Emit emit) {
  __shared__ unsigned long long s[RANK_CHUNK];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned long long* kb = kept + (size_t)b * n_keep;
  const unsigned long long mine = i < n_keep ? kb[i] : 0ull;
  int r = 0;
  for (int c0 = 0; c0 < n_keep; c0 += RANK_CHUNK) {
    const int len = min(RANK_CHUNK, n_keep - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) s[j] = kb[c0 + j];
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < len; ++j) r += s[j] > mine;
  }
  if (i < n_keep) emit(b, mine, r);
}

// float -> uint32 with the same order as the floats under XLA's total order
// (-0.0 < 0.0), so (score desc, position asc) packs into one unique key.
__device__ __forceinline__ uint32_t ordered_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The current device's SM count (the launch heuristics' unit of "enough
// work to fill the card").
inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// cp.async of one 4-byte word from global to shared memory, and its group
// bookkeeping (per thread; __syncwarp/__syncthreads publish the words).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
// cp.async of 16 (4) bytes with zero fill: src_bytes 0 writes zeros and
// reads nothing. The 16-byte form caches in L2 only (.cg), for streams.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- mbarriers and bulk copies (Hopper) -------------------------------------
// A phase wait that has not completed after about ten seconds traps: a
// protocol fault then fails its launch instead of hanging the card.
constexpr long long MBAR_TIMEOUT_CYCLES = 1ll << 34;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// After the inits, before another thread uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more of bulk-copy transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0)
      start = now;
    else if (now - start > MBAR_TIMEOUT_CYCLES)
      __trap();
  }
}
// Order this thread's earlier shared-memory accesses before later bulk
// copies into shared memory (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
