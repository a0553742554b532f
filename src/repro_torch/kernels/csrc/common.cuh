// Device helpers shared by the kernels: block-wide exclusive scan, a warp
// exclusive scan, the cuts (each of n unique keys to its rank), order-
// preserving float bits and cp.async (plain and zero-filling).
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
