// Candidate generation's masked top-nprobe: for each (query, term) row of
// the centroid scores, the ids of its nprobe best centroids among those
// whose score passes th, the others ranked below every survivor at
// score - 1e6.
//
// Replaces no TPU kernel: the reference selects with lax.top_k
// (repro/core/bitvector.py:86, masked_topk_centroids). The port's plain
// version (core/bitvector.py::masked_topk_plain) follows it through
// core/topk.py: one unique int64 key per entry (the masked value's
// total-order bits, then the position) over all B x n_q x n_c entries,
// and torch.topk over them. At B = 32, n_q = 32 and n_c = 2^18 that is
// six elementwise passes and a radix select over 2 GiB of keys: 15.5 ms of
// a 23 ms retrieve call on the H100 (PERF.md), and 5.6 GB of temporaries
// at the call's memory peak.
//
// What bounds it on the H100: bytes. It must read the CS once (B x n_q x
// n_c, 1.074 GB of float32 at B = 32, half that in bf16) and write B x n_q
// x nprobe ids (16 KB): about 0.321 ms at 3.35 TB/s (0.010 ms at B = 1).
// Its few integer operations an entry are far below the card's rate.
//
// What the design does about it:
//  * Every entry gets the plain version's key: v = float(cs) (bf16 widened
//    exactly), m = v > th ? v : v - 1e6 (one IEEE float32 subtraction, as
//    torch's), and key = ordered_bits(m) << 32 | ~c, so -0.0 < 0.0 and
//    equal values rank the lowest c first. The keys of a row are unique,
//    so any exact selection of the largest gives lax.top_k's ids in its
//    order. th comes rounded on the host to the value the plain version
//    compares with (core/precision.py). No key is stored.
//  * The register form, nprobe <= 32 (every config of the repository):
//    one block a row, or at fewer than 2 x SMs rows (B = 1 has 32) a
//    thread-block cluster of up to 8 blocks a row, each block a contiguous
//    part of it. A thread streams its share with 16-byte loads (four
//    float32 or eight bf16 entries), UNROLL loads in flight, neighbouring
//    threads on neighbouring addresses, and keeps its K = next_pow2(nprobe)
//    best keys sorted in registers (TopList<K>, compile-time indices). A
//    thread visits its entries in ascending c, so an entry whose value does
//    not beat the thread's K-th value cannot beat it on the position
//    either: the test an entry is one 32-bit compare, and a key is built
//    only for an insertion. Then each warp merges its lanes' lists by K
//    rounds of a shuffle max, one warp merges the block's warp lists from
//    shared memory, and in a cluster the first block merges the blocks'
//    lists through distributed shared memory. A masked term (q_mask false)
//    reads nothing and writes n_c in every slot.
//  * Above nprobe = 32, an exact form of any size, untimed: common.cuh's
//    cut of any size over the same keys, read from the CS in every pass (a
//    radix select of the nprobe-th key, SELECT_PASSES launches, the keys
//    at or above it compacted, each written to its rank by counting), over
//    global scratch of rows x nprobe keys plus the select's bins.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;            // 16-byte loads a thread has in flight
constexpr int CLUSTER_MAX = 8;       // blocks a row, at most (portable)
constexpr int PART_MIN = 4096;       // entries a block's part, at least
constexpr int REGISTER_K = 32;       // the register form's largest nprobe
constexpr int ROWS_MAX = 65535;      // rows a launch of the exact form
constexpr float MISS = 1e6f;         // offset of the entries at or below th

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The high half of an entry's key: its masked value in XLA's total order.
// Every value but NaN gives at least 0x007FFFFF (-inf), so the key 0 is
// below every real key and marks an empty slot.
__device__ __forceinline__ uint32_t masked_bits(float v, float th) {
  return ordered_bits(v > th ? v : __fsub_rn(v, MISS));
}

__device__ __forceinline__ unsigned long long key_of(uint32_t u, int c) {
  return (unsigned long long)u << 32 | (uint32_t)~(uint32_t)c;
}

__device__ __forceinline__ int32_t id_of(unsigned long long key) {
  return (int32_t)~(uint32_t)key;
}

// A thread's K largest keys, descending, in registers.
template <int K>
struct TopList {
  unsigned long long k[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) k[j] = 0ull;
  }
  // Insert a key above the smallest held one; the smallest drops out.
  __device__ __forceinline__ void insert(unsigned long long key) {
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      const unsigned long long up = j > 0 ? k[j > 0 ? j - 1 : 0] : ~0ull;
      if (key > k[j]) k[j] = key > up ? up : key;
    }
  }
  __device__ __forceinline__ void offer(unsigned long long key) {
    if (key > k[K - 1]) insert(key);
  }
  // Drop the largest key.
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) k[j] = k[j + 1];
    k[K - 1] = 0ull;
  }
};

// Entries [lo, hi) of a row into the thread's list, each thread's entries
// in ascending c: the few before the first 16-byte boundary, then 16-byte
// vectors, then the few after the last. `floor` is the value half of the
// list's smallest key.
template <int K, typename T>
__device__ __forceinline__ void scan_part(const T* __restrict__ row, int lo,
                                          int hi, float th, TopList<K>& top) {
  constexpr int V = 16 / sizeof(T);
  const int t = threadIdx.x;
  uint32_t floor = 0;
  auto take = [&](float v, int c) {
    const uint32_t u = masked_bits(v, th);
    if (u > floor) {
      top.insert(key_of(u, c));
      floor = (uint32_t)(top.k[K - 1] >> 32);
    }
  };
  const int mis = (int)(reinterpret_cast<uintptr_t>(row + lo) & 15) /
                  (int)sizeof(T);
  const int head = min(mis ? V - mis : 0, hi - lo);
  if (t < head) take(widen(row[lo + t]), lo + t);
  const int a = lo + head;
  const int nvec = (hi - a) / V;
  const uint4* __restrict__ vec = reinterpret_cast<const uint4*>(row + a);
  for (int v0 = 0; v0 < nvec; v0 += UNROLL * THREADS) {
    uint4 x[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = v0 + j * THREADS + t;
      x[j] = i < nvec ? __ldcs(vec + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = v0 + j * THREADS + t;
      if (i >= nvec) break;
      const int c = a + i * V;
      const uint32_t w[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (V == 4) {
          take(__uint_as_float(w[e]), c + e);
        } else {            // bf16: the lower address in the low half
          take(__uint_as_float(w[e] << 16), c + 2 * e);
          take(__uint_as_float(w[e] & 0xFFFF0000u), c + 2 * e + 1);
        }
      }
    }
  }
  const int tail = a + nvec * V;
  if (t < hi - tail) take(widen(row[tail + t]), tail + t);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(FULL_MASK, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// The K largest keys of the warp's lists, descending: emit(r, key) on
// lane 0 for rank r. The lists are used up.
template <int K, typename Emit>
__device__ __forceinline__ void warp_merge(TopList<K>& top, Emit emit) {
#pragma unroll 1
  for (int r = 0; r < K; ++r) {
    const unsigned long long m = warp_max(top.k[0]);
    if (top.k[0] == m) top.pop();     // unique keys; empty slots pop alike
    if ((threadIdx.x & 31) == 0) emit(r, m);
  }
}

// The K largest of n keys at src (this block's shared memory, or another
// block's mapped through the cluster), by one warp.
template <int K, typename Emit>
__device__ __forceinline__ void warp_select(const unsigned long long* src,
                                            int n, Emit emit) {
  TopList<K> top;
  top.clear();
  for (int i = threadIdx.x & 31; i < n; i += 32) top.offer(src[i]);
  warp_merge(top, emit);
}

// The register form. grid (rows x parts), THREADS; launched as clusters of
// `parts` blocks when parts > 1, block `part` of a row taking entries
// [part x part_len, (part + 1) x part_len).
template <int K, typename T>
__global__ void __launch_bounds__(THREADS)
topnprobe_kernel(const T* __restrict__ cs, float th,
                 const uint8_t* __restrict__ qmask, int n_c, int nprobe,
                 int parts, int part_len, int32_t* __restrict__ ids) {
  __shared__ unsigned long long s_warp[WARPS * K];
  __shared__ unsigned long long s_block[K];
  const int row = blockIdx.x / parts, part = blockIdx.x % parts;
  int32_t* out = ids + (size_t)row * nprobe;
  if (qmask != nullptr && !qmask[row]) {      // the whole cluster leaves
    if (part == 0 && threadIdx.x < nprobe) out[threadIdx.x] = n_c;
    return;
  }
  const int lo = part * part_len, hi = min(n_c, lo + part_len);
  TopList<K> top;
  top.clear();
  if (lo < hi) scan_part<K>(cs + (size_t)row * n_c, lo, hi, th, top);
  const int w = threadIdx.x >> 5;
  warp_merge(top, [&](int r, unsigned long long key) {
    s_warp[w * K + r] = key;
  });
  __syncthreads();
  auto write = [&](int r, unsigned long long key) {
    if (r < nprobe) out[r] = id_of(key);
  };
  if (parts == 1) {
    if (w == 0) warp_select<K>(s_warp, WARPS * K, write);
    return;
  }
  if (w == 0)
    warp_select<K>(s_warp, WARPS * K, [&](int r, unsigned long long key) {
      s_block[r] = key;
    });
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                 // every block's list is in place
  if (part == 0 && w == 0) {
    TopList<K> all;
    all.clear();
    for (int i = threadIdx.x; i < parts * K; i += 32)
      all.offer(cluster.map_shared_rank(s_block, i / K)[i % K]);
    warp_merge(all, write);
  }
  cluster.sync();                 // no block leaves while its list is read
}

template <int K, typename T>
cudaError_t launch_registers(const T* cs, float th, const uint8_t* qmask,
                             int rows, int n_c, int nprobe, int32_t* ids,
                             cudaStream_t st) {
  const int fill = 2 * sm_count();
  int parts = rows >= fill ? 1 : (fill + rows - 1) / rows;
  parts = std::min({parts, CLUSTER_MAX, std::max(1, n_c / PART_MIN)});
  const int part_len = ((n_c + parts - 1) / parts + 15) / 16 * 16;
  parts = (n_c + part_len - 1) / part_len;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * parts, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = parts;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, topnprobe_kernel<K, T>, cs, th, qmask, n_c, nprobe, parts,
      part_len, ids);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The exact form of any nprobe: common.cuh's cut of any size over the keys
// of a launch's rows (b = the row within the launch).
template <typename T>
struct RowKey {
  const T* cs;
  float th;
  int n_c;
  __device__ __forceinline__ unsigned long long operator()(int b,
                                                           int c) const {
    return key_of(masked_bits(widen(cs[(size_t)b * n_c + c]), th), c);
  }
};

struct IdEmit {
  const uint8_t* qmask;
  int n_c, nprobe;
  int32_t* ids;
  __device__ __forceinline__ void operator()(int b, unsigned long long key,
                                             int r) const {
    ids[(size_t)b * nprobe + r] =
        qmask != nullptr && !qmask[b] ? n_c : id_of(key);
  }
};

template <typename T>
__global__ void __launch_bounds__(SELECT_THREADS)
topnprobe_select_kernel(RowKey<T> key, int n, int n_keep, int pass,
                        SelectState* state, int* bins) {
  select_pass(key, n, n_keep, pass, state, bins);
}

template <typename T>
__global__ void __launch_bounds__(SELECT_THREADS)
topnprobe_compact_kernel(RowKey<T> key, int n, int n_keep,
                         SelectState* state, unsigned long long* kept) {
  select_compact(key, n, n_keep, state, kept);
}

__global__ void __launch_bounds__(RANK_THREADS)
topnprobe_rank_kernel(const unsigned long long* kept, int n_keep,
                      IdEmit emit) {
  rank_counted(kept, n_keep, emit);
}

template <typename T>
cudaError_t launch_exact(const T* cs, float th, const uint8_t* qmask,
                         int rows, int n_c, int nprobe, int32_t* ids,
                         void* scratch, cudaStream_t st) {
  CutScratch s;
  cut_scratch(scratch, std::min(rows, ROWS_MAX), nprobe, &s);
  const size_t zero = reinterpret_cast<char*>(s.kept) -
                      static_cast<char*>(scratch);
  cudaError_t err = cudaSuccess;
  for (int r0 = 0; r0 < rows; r0 += ROWS_MAX) {
    const int nb = std::min(ROWS_MAX, rows - r0);
    const RowKey<T> key{cs + (size_t)r0 * n_c, th, n_c};
    const IdEmit emit{qmask == nullptr ? nullptr : qmask + r0, n_c, nprobe,
                      ids + (size_t)r0 * nprobe};
    if ((err = cudaMemsetAsync(scratch, 0, zero, st)) != cudaSuccess)
      return err;
    const dim3 grid(select_blocks(nb, n_c, sm_count()), nb);
    for (int pass = 0; pass < SELECT_PASSES; ++pass) {
      topnprobe_select_kernel<<<grid, SELECT_THREADS, 0, st>>>(
          key, n_c, nprobe, pass, s.state, s.bins);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    topnprobe_compact_kernel<<<grid, SELECT_THREADS, 0, st>>>(
        key, n_c, nprobe, s.state, s.kept);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    topnprobe_rank_kernel<<<dim3((nprobe + RANK_THREADS - 1) / RANK_THREADS,
                                 nb),
                            RANK_THREADS, 0, st>>>(s.kept, nprobe, emit);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return err;
}

template <typename T>
cudaError_t launch(const T* cs, float th, const uint8_t* qmask, int rows,
                   int n_c, int nprobe, int32_t* ids, void* scratch,
                   cudaStream_t st) {
  auto regs = [&](auto k) {
    return launch_registers<decltype(k)::value>(cs, th, qmask, rows, n_c,
                                                nprobe, ids, st);
  };
  switch (next_pow2(nprobe)) {
    case 1: return regs(std::integral_constant<int, 1>{});
    case 2: return regs(std::integral_constant<int, 2>{});
    case 4: return regs(std::integral_constant<int, 4>{});
    case 8: return regs(std::integral_constant<int, 8>{});
    case 16: return regs(std::integral_constant<int, 16>{});
    case 32: return regs(std::integral_constant<int, 32>{});
    default:
      return launch_exact(cs, th, qmask, rows, n_c, nprobe, ids, scratch, st);
  }
}

}  // namespace

extern "C" {

// Bytes of device scratch topnprobe needs: none in the register form.
size_t topnprobe_scratch_bytes(int rows, int nprobe) {
  if (nprobe <= REGISTER_K) return 0;
  return cut_scratch(nullptr, std::min(rows, ROWS_MAX), nprobe, nullptr);
}

// All pointers are device pointers; qmask may be null (every row live).
// cs (rows, n_c) f32, or bf16 when cs_bf16; th the float32 value the
// plain version compares with; qmask (rows,) u8; 1 <= nprobe <= n_c.
// ids (rows, nprobe) i32 out, n_c in every slot of a masked row. scratch:
// the bytes topnprobe_scratch_bytes gives, 256-byte aligned (null when 0).
int topnprobe(const void* cs, int cs_bf16, float th, const uint8_t* qmask,
              int rows, int n_c, int nprobe, int32_t* ids, void* scratch,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_cs(cs, cs_bf16, [&](auto p) {
    return (int)launch(p, th, qmask, rows, n_c, nprobe, ids, scratch, st);
  });
}

}  // extern "C"
