// Unfused EMVB phase 1b: the stacked bit vectors of a micro-batch. Bit i of
// word c of query b is set when term i is live and cs[b, i, c] > th.
//
// Replaces: repro/kernels/bitpack.py::bitpack (Pallas body _bitpack_kernel,
// bitpack.py:22, pallas_call :52), batched: row b is the reference kernel on
// query b.
//
// What bounds it on the H100: bytes. It reads the CS once (B x n_q x n_c
// fp32, 1.07 GB at B = 32, n_q = 32, n_c = 2^18; half that in bf16) and
// writes B x n_c words (32 MiB): about 0.33 ms at 3.35 TB/s (0.17 ms in
// bf16). Its B x n_q x n_c compares are far below the card's rate.
//
// CS is float32 or bf16 (bitpack_kernel<T>). The reference compares in
// float32 either way (its threshold is a float32 array, bitpack.py:26), so
// th comes as the float32 value and a bf16 entry is widened before the
// compare.
//
// What the design does about it: one thread per (centroid column, query).
// A warp's 32 threads read 32 neighbouring columns of one CS row (one
// 128-byte line per term) and write 32 neighbouring words. The column pack
// is emvb::pack_column, which the fused prefilter's pack pass also runs
// (one 16-byte load of columns at a time, emvb::pack_columns, where n_c
// allows).
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int THREADS = 256;

// grid (ceil(n_c / THREADS), B).
template <typename T>
__global__ void bitpack_kernel(const T* __restrict__ cs, float th,
                               const uint8_t* __restrict__ qmask, int n_q,
                               int n_c, uint32_t* __restrict__ bits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= n_c) return;
  bits[(size_t)b * n_c + c] = emvb::pack_column(
      cs + (size_t)b * n_q * n_c + c, n_c, th,
      emvb::live_terms(emvb::mask_row(qmask, b, n_q), n_q), n_q);
}

}  // namespace

extern "C" {

// All pointers are device pointers; qmask may be null (every term live).
// cs (B, n_q, n_c) f32, or bf16 when cs_bf16; th the float32 threshold;
// qmask (B, n_q) u8; bits (B, n_c) u32 out.
int bitpack_batched(const void* cs, int cs_bf16, float th,
                    const uint8_t* qmask, int B, int n_q, int n_c,
                    uint32_t* bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_c + THREADS - 1) / THREADS, B);
  return with_cs(cs, cs_bf16, [&](auto p) {
    bitpack_kernel<<<grid, THREADS, 0, st>>>(p, th, qmask, n_q, n_c, bits);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
