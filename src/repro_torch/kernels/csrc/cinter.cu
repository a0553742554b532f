// Unfused EMVB phase 3: the centroid interaction S̄ (Eq. 2) of every
// survivor of each query: per live term the max over valid tokens of
// cs_t[code, term], masked terms 0.0, then term_sum.
//
// Replaces: repro/kernels/cinter.py::cinter (Pallas body _cinter_kernel,
// cinter.py:77, calling sbar_block :31; pallas_call :99), batched: row b is
// the reference kernel on query b.
//
// What bounds it on the H100: the bytes are small — the survivors' codes
// and lengths, the rows of CS^T their tokens touch (n_q elements each) and
// B x docs floats out. What costs time is latency and the number of
// dependent loads: per (doc, token) a gather of a CS^T row addressed by the
// token's code; at B = 32 those gathers read ~0.29 GB through L2 (float32)
// for ~61 MB of distinct rows.
//
// What the design does about it: the whole pass is emvb::sbar_block
// (doc_math.cuh), the one S̄ pass that the fused pqinter.cu's pass 1 runs
// too, so the two lanes agree to the bit. A warp loads up to 128 of a
// doc's codes at once (32 a coalesced load, beside the doc's length) and
// hands them from lane to lane by shuffles; when a row of CS^T is a whole
// number of 16-byte pieces at an aligned base (n_q % 4 == 0 in float32,
// % 8 in bf16), a piece a lane, one warp load gathers 4 (float32) or 8
// (bf16) tokens' rows at n_q = 32, and a round's gathers are all issued
// before its first max; other shapes run one lane per term. A doc's
// tokens are split over up to 8 warps (4 at B = 1) when the batch has too
// few docs to fill the card, by the rule pqinter's pass uses
// (emvb::sbar_launch).
//
// CS^T is float32 or bf16 (cinter_kernel<LP, T>). On bf16 S̄ is the
// reference's bf16 sum (per-term bf16 maxima, the float32 term chain
// rounded once to bf16), written widened to float32 as the reference
// kernel writes it (cinter.py:109); the rows it gathers are half as many
// bytes.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

// grid and split from emvb::sbar_launch; LP its form.
template <int LP, typename T>
__global__ void
__launch_bounds__(emvb::SBAR_WARPS * 32, emvb::SBAR_MIN_BLOCKS)
cinter_kernel(const T* __restrict__ cs_t, const int32_t* __restrict__ codes,
              const int32_t* __restrict__ lens,
              const uint8_t* __restrict__ qmask, int nd, int cap, int n_c,
              int n_q, int split, float* __restrict__ sbar) {
  emvb::sbar_block<LP>(cs_t, codes, lens, qmask, nd, cap, n_c, n_q, split,
                       sbar);
}

}  // namespace

extern "C" {

// All pointers are device pointers; qmask may be null (every term live).
// cs_t (B, n_c, n_q) f32, or bf16 when cs_bf16; codes (B, nd, cap) i32;
// lens (B, nd) i32; qmask (B, n_q) u8. Output: sbar (B, nd) f32.
int cinter_batched(const void* cs_t, int cs_bf16, const int32_t* codes,
                   const int32_t* lens, const uint8_t* qmask, int B, int nd,
                   int cap, int n_c, int n_q, float* sbar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_cs(cs_t, cs_bf16, [&](auto p) {
    const emvb::SbarLaunch s = emvb::sbar_launch(p, B, nd, cap, n_q);
    emvb::with_sbar_lanes(s.lanes, [&](auto lp) {
      cinter_kernel<decltype(lp)::value>
          <<<s.grid, emvb::SBAR_WARPS * 32, 0, st>>>(
              p, codes, lens, qmask, nd, cap, n_c, n_q, s.split, sbar);
    });
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
