// Unfused EMVB phase 4: the PQ late-interaction score (Eq. 5, or Eq. 6 with
// the dynamic term filter) of every phase-3 winner of each query.
//
// Replaces: repro/kernels/pqscore.py::pqscore (Pallas body _pqscore_kernel,
// pqscore.py:116, calling eq56_block :33; pallas_call :149), batched: row b
// is the reference kernel on query b. The reference widens the residual
// codes to int32 in its wrapper (:139); here they stay uint8 in memory.
//
// What bounds it on the H100: the bytes are small — the winners' codes,
// residual codes (m bytes a token) and lengths, the CS^T rows their tokens
// touch, the LUT (512 KiB a query at n_q = 32, m = 16, K = 256) and B x docs
// floats out. What costs time is where the m + 1 reads of every (doc, token,
// term) are served. Read as 128-byte LUT rows through L2 (the L2 form
// below: 1.27 GB of rows for 8,192 winners at B = 32), they run at L2's line
// rate, ~6.6 TB/s.
//
// What the design does about it: it is the fused pqinter's Eq. 5/6 pass,
// doc_math.cuh's cluster pass (emvb::eq56_cluster; the section note there
// has the whole design), on rows read directly instead of through sel2. A
// cluster of up to 8 CTAs holds a query's LUT in shared memory, a slice of
// T terms a CTA (4 CTAs of 8 terms at emvb-msmarco's shape), so the LUT
// reads are shared-memory reads of 4 terms a lane, about two wavefronts a
// quarter warp, not L2 lines; each CTA finishes its terms and the cluster's
// CTAs term-sum the docs in lane order through distributed shared memory.
// emvb::eq56_plan picks T and how many clusters share a query from the
// shape. For m = 16 a token's 16 residual codes are one vector load and its
// 16 LUT reads are all in flight before the first add; any other m runs the
// serial form. Only a LUT whose one-term slice does not fit shared memory
// (m * K above ~54,000) runs the L2 form, pqscore_l2_kernel
// (emvb::eq56_block).
//
// CS^T is float32 or bf16 (pqscore_kernel<M, T>). On bf16 a token's full
// score is its widened bf16 centroid score plus the float32 residual, and
// Eq. 6 compares the centroid score with th_r rounded to bf16 on the host,
// as the reference's eq56_block does (pqscore.py:52-62).
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int E_SPLIT = 8;     // warps a doc in the L2 form

// The cluster pass; M is m when known at compile time, else 0.
template <int M, typename T>
__global__ void __launch_bounds__(emvb::E56_THREADS, 1)
pqscore_kernel(const emvb::Eq56Args<T> a) {
  emvb::eq56_cluster<M>(a);
}

// The L2 form, grid (nd, B), one doc a block (three blocks an SM: without
// the bound the compiler gives the m = 16 form more registers and two
// blocks an SM, fewer warps to hide the LUT reads).
template <int M, typename T>
__global__ void __launch_bounds__(E_SPLIT * 32, 3)
pqscore_l2_kernel(const T* __restrict__ cs_t, const float* __restrict__ lut2,
                  const int32_t* __restrict__ codes,
                  const uint8_t* __restrict__ res,
                  const int32_t* __restrict__ lens,
                  const uint8_t* __restrict__ qmask, int nd, int cap,
                  int n_c, int n_q, int m, int ksub, int rows, float th_r,
                  int use_filter, float* __restrict__ score) {
  emvb::eq56_block<M, E_SPLIT>(cs_t, lut2, codes, res, lens, qmask, nullptr,
                               nd, nd, cap, n_c, n_q, m, ksub, rows, th_r,
                               use_filter, score);
}

// The plan of a launch (emvb::eq56_plan) for the instantiation it runs.
template <typename T>
cudaError_t plan(const uint8_t* res, int B, int nd, int n_q, int m, int ksub,
                 int runs, emvb::Eq56Plan* p) {
  const void* kern = emvb::eq56_vector_m16(m, res)
                         ? (const void*)pqscore_kernel<16, T>
                         : (const void*)pqscore_kernel<0, T>;
  return emvb::eq56_plan(kern, B, nd, n_q, m, ksub, runs, p);
}

// One launch on cs_t (B, n_c, n_q) of T; lut2 (B, G, rows, terms) f32 from
// flat_lut with the plan's terms; codes (B, nd, cap) i32; res (B, nd, cap,
// m) u8; lens (B, nd) i32; qmask (B, n_q) u8; th_r rounded to the CS type;
// runs > 0 overrides the plan's runs a query. Output: score (B, nd) f32.
template <typename T>
int launch(const T* cs_t, const float* lut2, int terms, const int32_t* codes,
           const uint8_t* res, const int32_t* lens, const uint8_t* qmask,
           int B, int nd, int cap, int n_c, int n_q, int m, int ksub,
           float th_r, int use_filter, int runs, float* score,
           cudaStream_t st) {
  emvb::Eq56Plan p;
  cudaError_t err = plan<T>(res, B, nd, n_q, m, ksub, runs, &p);
  if (err != cudaSuccess) return err;
  if (terms != p.terms) return cudaErrorInvalidValue;   // the LUT's layout
  const bool m16 = emvb::eq56_vector_m16(m, res);
  if (!p.cluster_form) {
    const dim3 grid(nd, B);
    const int rows = emvb::e56_rows(m * ksub, n_q);
    if (m16)
      pqscore_l2_kernel<16, T><<<grid, E_SPLIT * 32, 0, st>>>(
          cs_t, lut2, codes, res, lens, qmask, nd, cap, n_c, n_q, m, ksub,
          rows, th_r, use_filter, score);
    else
      pqscore_l2_kernel<0, T><<<grid, E_SPLIT * 32, 0, st>>>(
          cs_t, lut2, codes, res, lens, qmask, nd, cap, n_c, n_q, m, ksub,
          rows, th_r, use_filter, score);
    return cudaGetLastError();
  }
  const emvb::Eq56Args<T> a = emvb::eq56_args(
      cs_t, lut2, codes, res, lens, qmask, nullptr, score, B, nd, nd, cap,
      n_c, n_q, m, ksub, th_r, use_filter, p);
  err = m16 ? emvb::eq56_launch(pqscore_kernel<16, T>, p, a, st)
            : emvb::eq56_launch(pqscore_kernel<0, T>, p, a, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// T, the terms a group of the LUT layout flat_lut makes: the cluster pass's,
// or n_q (one group) where the L2 form runs.
int pqscore_lut_terms(int n_q, int m, int ksub) {
  const int t = emvb::eq56_terms(n_q, m, ksub);
  return t > 0 ? t : n_q;
}

// The plan of a pqscore_batched launch over B queries' nd docs with these
// residual codes, as 10 numbers: cluster_form, terms, groups, cluster,
// passes, rows, runs, clusters, smem, staged_bytes (emvb::Eq56Plan).
int pqscore_plan(int cs_bf16, const uint8_t* res, int B, int nd, int n_q,
                 int m, int ksub, int runs, long long* out) {
  emvb::Eq56Plan p;
  const cudaError_t err =
      cs_bf16 ? plan<__nv_bfloat16>(res, B, nd, n_q, m, ksub, runs, &p)
              : plan<float>(res, B, nd, n_q, m, ksub, runs, &p);
  const long long v[10] = {p.cluster_form, p.terms,  p.groups,
                           p.cluster,      p.passes, p.rows,
                           p.runs,         p.clusters, p.smem,
                           p.staged_bytes};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return err;
}

// All pointers are device pointers; qmask may be null (every term live).
// cs_t (B, n_c, n_q) f32, or bf16 when cs_bf16; lut2 the flat_lut layout of
// `terms` (pqscore_lut_terms); runs 0 for the plan's schedule; the other
// operands as in launch.
int pqscore_batched(const void* cs_t, int cs_bf16, const float* lut2,
                    int terms, const int32_t* codes, const uint8_t* res,
                    const int32_t* lens, const uint8_t* qmask, int B, int nd,
                    int cap, int n_c, int n_q, int m, int ksub, float th_r,
                    int use_filter, int runs, float* score, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_cs(cs_t, cs_bf16, [&](auto p) {
    return launch(p, lut2, terms, codes, res, lens, qmask, B, nd, cap, n_c,
                  n_q, m, ksub, th_r, use_filter, runs, score, st);
  });
}

}  // extern "C"
