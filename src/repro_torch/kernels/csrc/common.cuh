// Device helpers shared by the kernels: block-wide exclusive scan and an
// in-shared-memory bitonic sort (descending) of unique keys.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Exclusive prefix sum of one int per thread across the block (blockDim.x a
// multiple of 32, at most 1024). `sw` is 32 ints of shared scratch; the
// block total lands in *total. Every thread of the block must call it.
__device__ __forceinline__ int block_excl_scan(int v, int* sw, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sw[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? sw[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
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

// float -> uint32 with the same order as the floats under XLA's total order
// (-0.0 < 0.0), so (score desc, position asc) packs into one unique key.
__device__ __forceinline__ uint32_t ordered_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}
