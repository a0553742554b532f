// Fused EMVB phases 3-4 over each query's phase-2 survivors: centroid
// interaction S̄ (Eq. 2), the top-n_docs cut, PQ late interaction with the
// dynamic term filter (Eq. 5/6) and the final top-k.
//
// Replaces: repro/kernels/pqinter.py::pqinter_batched (Pallas body
// _pqinter_batched_kernel, pqinter.py:256, which inlines
// cinter.py::sbar_block_batched and pqscore.py::eq56_block_batched) and, at
// B = 1, pqinter.py::pqinter (_pqinter_kernel, :87).
//
// What bounds it on the H100: the bytes it must move are small — the
// survivors' codes, residual codes and lengths, the LUT (512 KiB per query
// at n_q = 32, m = 16, K = 256) and the rows of CS^T the survivors' tokens
// touch. What costs time is where the Eq. 5/6 pass's m + 1 reads of every
// (winner, token, term) are served — gathered as 128-byte LUT rows through
// L2 they ran at L2's line rate, ~6.6 TB/s (83 % of fig9's call at B = 32,
// PERF.md) — then the S̄ pass's CS^T gathers and two cuts per query.
//
// What the design does about it:
//  * Pass 1 (S̄) is emvb::sbar_block (doc_math.cuh), the one S̄ pass that
//    the unfused cinter.cu runs too: a warp loads up to 128 of a doc's
//    codes at once (32 a coalesced load) and shuffles them across; at
//    n_q = 32 one warp load gathers 4 float32 (8 bf16) tokens' CS^T rows
//    as 16-byte pieces, a round's gathers all in flight before its first
//    max (other row widths and unaligned bases: one lane per term). A
//    doc's tokens are split over as many warps (up to 8) as the card holds
//    in one wave with the batch's survivors (emvb::sbar_launch): one at
//    B = 32, four at B = 1.
//  * The Eq. 5/6 pass is doc_math.cuh's cluster pass (emvb::eq56_cluster,
//    whose section note has the whole design): a thread-block cluster of up
//    to 8 CTAs holds a query's LUT in shared memory, a slice of T terms a
//    CTA (4 CTAs of 8 terms at emvb-msmarco's shape), staged by bulk copies;
//    a warp scores a winner at a time with lanes (token slot, term quad), so
//    the LUT reads are 16-byte shared-memory reads (about two wavefronts a
//    quarter warp) instead of 128-byte L2 lines; the per-term states merge
//    exactly (order-free maxima and counts) by shuffles, each CTA finishes
//    its terms (the -1e9 floor, Eq. 6's fallback, masked terms 0.0) and the
//    cluster's CTAs term-sum the winners through distributed shared memory
//    in lane order. emvb::eq56_plan picks T and how many clusters share a
//    query from the shape; only a LUT whose one-term slice does not fit
//    shared memory runs the L2 form (eq56_l2_kernel: one block a winner,
//    every LUT read a 128-byte row through L2). The LUT is not narrowed
//    (narrowing changes bits). For emvb-msmarco's m = 16, m is a
//    compile-time constant: a token's 16 residual codes arrive in one
//    vector load and its 16 LUT reads are all issued before the first add,
//    which keeps the reference's order s = 0, 1, ..., m-1. Any other m
//    (emvb-smoke's 8 among them) runs the serial form.
//  * Both cuts pack (score, position) into unique 64-bit keys —
//    (S̄ desc, survivor position asc) for phase 3 and (score desc, phase-3
//    rank asc) for phase 4, the order the reference's running merges give —
//    and write each kept key to its rank among the keys. While a cut's n
//    keys fit shared memory (n <= CUT_SHARED_MAX = 4096, every default
//    config) that is common.cuh's cut_keys (select1 and select2): counted
//    over lanes and several blocks a query while B x n is small, so at B = 1
//    a cut runs on many SMs; sorted in one block a query above that. Larger
//    cuts, up to the whole corpus (fig2's baseline keeps 128 of 8,841,823
//    survivors; fig9's post-filter lane 10,000 of 20,000), take common.cuh's
//    cut of any size: a radix select of the n_keep-th key over global
//    scratch (select_pass, SELECT_PASSES launches of several blocks a
//    query), the kept keys compacted (select_compact) and ranked by
//    counting over many blocks while B x n_keep is small (rank_count), by
//    one block's sort in opt-in shared memory above that, up to 16,384
//    kept keys (rank_sort), and by counting again past that. The keys are
//    read from S̄ (or the Eq. 5/6 scores) in every pass, never stored whole.
//  * The S̄ pass is the unfused cinter.cu's and the Eq. 5/6 pass is the one
//    the unfused pqscore.cu runs too. So the two lanes agree to the bit.
//
// Filtered retrieval (doc_pass (B, nf), the predicate verdict per survivor,
// the reference's pqinter.py:265-279 and :309): a survivor that fails is
// -inf in both cuts. The reference's running merges keep their buffer's
// entries first on ties, so when fewer than n_docs survivors pass, the
// phase-3 cut ends in (-inf, position -1) fillers, never in a failing
// survivor, and when fewer than k pass the final cut ends in (-inf,
// position 0). Here cut 1 (Cut1Key, Cut1Emit, in either form of a cut)
// ranks a failing survivor below every passing one and writes each of its
// slots as (position -1, S̄ -inf); the Eq. 5/6 pass (either form) scores a
// position -1 slot as -inf without reading a row; cut 2 (Cut2Emit) writes each -inf
// slot as (score -inf, position 0). Without doc_pass no step reads it, and
// the cuts are the unfiltered ones.
//
// CS^T is float32 or bf16 (sbar_kernel<LP, T>, eq56_kernel<M, T>), the
// reference's pqinter.py:115-118 and :279. On bf16 S̄ is the bf16 sum
// (per-term bf16 maxima, the float32 term chain rounded once), widened
// exactly for the phase-3 cut; its ties are frequent, and the cut's unique
// (S̄, position) keys break them as the reference's merges do. Eq. 5/6 adds
// the widened bf16 centroid score to the float32 residual and compares it
// with th_r rounded to bf16 on the host. The rows of CS^T are half as many
// bytes.
#include "common.cuh"
#include "doc_math.cuh"

namespace {

constexpr int E_SPLIT = 8;     // warps a doc in the L2 form of Eq. 5/6

// Pass 1: S̄ of every survivor row (emvb::sbar_block, the pass cinter.cu
// runs); grid and split from emvb::sbar_launch, LP its form.
template <int LP, typename T>
__global__ void
__launch_bounds__(emvb::SBAR_WARPS * 32, emvb::SBAR_MIN_BLOCKS)
sbar_kernel(const T* __restrict__ cs_t, const int32_t* __restrict__ codes,
            const int32_t* __restrict__ lens,
            const uint8_t* __restrict__ qmask, int nf, int cap, int n_c,
            int n_q, int split, float* __restrict__ sbar_all) {
  emvb::sbar_block<LP>(cs_t, codes, lens, qmask, nf, cap, n_c, n_q, split,
                       sbar_all);
}

// The keys and the writes of the two cuts, for either form of a cut.
// Cut 1: S̄ of survivor i, -inf when it fails doc_pass, and i.
struct Cut1Key {
  const float* sb;
  const uint8_t* ok;
  int nf;
  __device__ unsigned long long operator()(int b, int i) const {
    const size_t at = (size_t)b * nf + i;
    const float v = ok == nullptr || ok[at] ? sb[at] : -INFINITY;
    return ((unsigned long long)ordered_bits(v) << 32) |
           (0xffffffffu - (unsigned)i);
  }
};
struct Cut1Emit {
  const float* sb;
  const uint8_t* ok;
  int nf, n_docs;
  int32_t* sel2;
  float* sbar;
  __device__ void operator()(int b, unsigned long long key, int r) const {
    const int i = (int)(0xffffffffu - (unsigned)key);
    const size_t at = (size_t)b * nf + i;
    const bool filler = ok != nullptr && !ok[at];
    sel2[(size_t)b * n_docs + r] = filler ? -1 : i;
    sbar[(size_t)b * n_docs + r] = filler ? -INFINITY : sb[at];
  }
};
// Cut 2: the Eq. 5/6 score of phase-3 rank i, and i.
struct Cut2Key {
  const float* sc;
  int n_docs;
  __device__ unsigned long long operator()(int b, int i) const {
    return ((unsigned long long)ordered_bits(sc[(size_t)b * n_docs + i])
            << 32) | (0xffffffffu - (unsigned)i);
  }
};
struct Cut2Emit {
  const float* sc;
  const int32_t* sel2;
  int n_docs, k, filtered;
  float* scores;
  int32_t* pos;
  __device__ void operator()(int b, unsigned long long key, int j) const {
    const int i = (int)(0xffffffffu - (unsigned)key);
    const float v = sc[(size_t)b * n_docs + i];
    scores[(size_t)b * k + j] = v;
    pos[(size_t)b * k + j] =
        filtered && v == -INFINITY ? 0 : sel2[(size_t)b * n_docs + i];
  }
};

// A cut of at most CUT_SHARED_MAX keys: the n keys in shared memory, each
// of the n_keep largest written to its rank (common.cuh's cut_keys); a
// cut_launch grid.
template <typename Key, typename Emit>
__device__ __forceinline__ void cut_shared(Key key, int n, int P, bool sort,
                                           int n_keep, Emit emit) {
  extern __shared__ unsigned long long skeys[];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    skeys[i] = i < n ? key(b, i) : 0ull;
  __syncthreads();
  cut_keys(skeys, n, P, sort, [&](unsigned long long k, int r) {
    if (r < n_keep) emit(b, k, r);
  });
}

// Pass 1 cut: top-n_docs by (S̄ desc, position asc).
__global__ void __launch_bounds__(1024)
select1_kernel(Cut1Key key, int P, bool sort, Cut1Emit emit) {
  cut_shared(key, key.nf, P, sort, emit.n_docs, emit);
}

// Pass 2 cut: top-k by (score desc, phase-3 rank asc).
__global__ void __launch_bounds__(1024)
select2_kernel(Cut2Key key, int P, bool sort, Cut2Emit emit) {
  cut_shared(key, key.n_docs, P, sort, emit.k, emit);
}

// Pass 2: Eq. 5/6 score of each phase-3 winner, in rank order: the cluster
// pass (emvb::eq56_cluster, which pqscore.cu runs on its rows too) over
// sel2, a filler slot (position -1) scoring -inf; M is m when known at
// compile time, else 0.
template <int M, typename T>
__global__ void __launch_bounds__(emvb::E56_THREADS, 1)
eq56_kernel(const emvb::Eq56Args<T> a) {
  emvb::eq56_cluster<M>(a);
}

// Its L2 form, for LUTs whose one-term slice does not fit shared memory:
// grid (n_docs, B), one doc a block (emvb::eq56_block, as pqscore.cu's L2
// form, with the same bound of three blocks an SM).
template <int M, typename T>
__global__ void __launch_bounds__(E_SPLIT * 32, 3)
eq56_l2_kernel(const T* __restrict__ cs_t, const float* __restrict__ lut2,
               const int32_t* __restrict__ codes,
               const uint8_t* __restrict__ res,
               const int32_t* __restrict__ lens,
               const uint8_t* __restrict__ qmask,
               const int32_t* __restrict__ sel2, int nf, int cap, int n_c,
               int n_q, int m, int ksub, int rows, float th_r, int use_filter,
               int n_docs, float* __restrict__ score2) {
  const size_t slot = (size_t)blockIdx.y * n_docs + blockIdx.x;
  if (sel2[slot] < 0) {                              // block-uniform
    if (threadIdx.x == 0) score2[slot] = -INFINITY;
    return;
  }
  emvb::eq56_block<M, E_SPLIT>(cs_t, lut2, codes, res, lens, qmask, sel2, nf,
                               n_docs, cap, n_c, n_q, m, ksub, rows, th_r,
                               use_filter, score2);
}

// The plan of the Eq. 5/6 pass (emvb::eq56_plan) for the instantiation it
// runs.
template <typename T>
cudaError_t eq56_plan(const uint8_t* res, int B, int n_docs, int n_q, int m,
                      int ksub, int runs, emvb::Eq56Plan* p) {
  const void* kern = emvb::eq56_vector_m16(m, res)
                         ? (const void*)eq56_kernel<16, T>
                         : (const void*)eq56_kernel<0, T>;
  return emvb::eq56_plan(kern, B, n_docs, n_q, m, ksub, runs, p);
}

// The Eq. 5/6 pass over sel2's winners on plan p (lut2 in its layout).
template <typename T>
cudaError_t eq56_pass(const emvb::Eq56Plan& p, const T* cs_t,
                      const float* lut2, const int32_t* codes,
                      const uint8_t* res, const int32_t* lens,
                      const uint8_t* qmask, const int32_t* sel2, int B,
                      int nf, int cap, int n_c, int n_q, int m, int ksub,
                      float th_r, int use_filter, int n_docs, float* score2,
                      cudaStream_t st) {
  const bool m16 = emvb::eq56_vector_m16(m, res);
  if (!p.cluster_form) {
    const dim3 grid(n_docs, B);
    const int rows = emvb::e56_rows(m * ksub, n_q);
    if (m16)
      eq56_l2_kernel<16, T><<<grid, E_SPLIT * 32, 0, st>>>(
          cs_t, lut2, codes, res, lens, qmask, sel2, nf, cap, n_c, n_q, m,
          ksub, rows, th_r, use_filter, n_docs, score2);
    else
      eq56_l2_kernel<0, T><<<grid, E_SPLIT * 32, 0, st>>>(
          cs_t, lut2, codes, res, lens, qmask, sel2, nf, cap, n_c, n_q, m,
          ksub, rows, th_r, use_filter, n_docs, score2);
    return cudaGetLastError();
  }
  const emvb::Eq56Args<T> a = emvb::eq56_args(
      cs_t, lut2, codes, res, lens, qmask, sel2, score2, B, nf, n_docs, cap,
      n_c, n_q, m, ksub, th_r, use_filter, p);
  const cudaError_t err =
      m16 ? emvb::eq56_launch(eq56_kernel<16, T>, p, a, st)
          : emvb::eq56_launch(eq56_kernel<0, T>, p, a, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A cut of any size, the passes of common.cuh's select and rank.
template <typename Key>
__global__ void __launch_bounds__(SELECT_THREADS)
select_pass_kernel(Key key, int n, int n_keep, int pass, SelectState* state,
                   int* bins) {
  select_pass(key, n, n_keep, pass, state, bins);
}

template <typename Key>
__global__ void __launch_bounds__(SELECT_THREADS)
select_compact_kernel(Key key, int n, int n_keep, SelectState* state,
                      unsigned long long* kept) {
  select_compact(key, n, n_keep, state, kept);
}

template <typename Emit>
__global__ void __launch_bounds__(1024)
rank_sort_kernel(const unsigned long long* kept, int n_keep, int P,
                 Emit emit) {
  rank_sorted(kept, n_keep, P, emit);
}

template <typename Emit>
__global__ void __launch_bounds__(RANK_THREADS)
rank_count_kernel(const unsigned long long* kept, int n_keep, Emit emit) {
  rank_counted(kept, n_keep, emit);
}

// Keep the n_keep largest of each query's n keys, each written to its rank
// by emit; scratch holds cut_scratch(nullptr, B, n_keep, nullptr) bytes.
template <typename Key, typename Emit>
cudaError_t cut_any(Key key, int B, int n, int n_keep, Emit emit,
                    void* scratch, cudaStream_t st) {
  CutScratch cs;
  cut_scratch(scratch, B, n_keep, &cs);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, reinterpret_cast<char*>(cs.kept) -
                      static_cast<char*>(scratch), st);
  if (err != cudaSuccess) return err;
  const dim3 grid(select_blocks(B, n, sm_count()), B);
  for (int pass = 0; pass < SELECT_PASSES; ++pass) {
    select_pass_kernel<<<grid, SELECT_THREADS, 0, st>>>(key, n, n_keep, pass,
                                                        cs.state, cs.bins);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  select_compact_kernel<<<grid, SELECT_THREADS, 0, st>>>(key, n, n_keep,
                                                         cs.state, cs.kept);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int P = next_pow2(n_keep);
  if (P <= CUT_SORT_MAX && (long long)B * n_keep > CUT_SORT_ABOVE) {
    const size_t smem = (size_t)P * sizeof(unsigned long long);
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             rank_sort_kernel<Emit>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess)
      return err;
    rank_sort_kernel<<<dim3(1, B), 1024, smem, st>>>(cs.kept, n_keep, P,
                                                      emit);
  } else {
    rank_count_kernel<<<dim3((n_keep + RANK_THREADS - 1) / RANK_THREADS, B),
                        RANK_THREADS, 0, st>>>(cs.kept, n_keep, emit);
  }
  return cudaGetLastError();
}

// Scratch of run(): S̄ of every survivor, the Eq. 5/6 scores, and a cut of
// any size's scratch when a cut exceeds the shared-memory forms.
struct RunScratch {
  float* sbar_all;   // (B, nf)
  float* score2;     // (B, n_docs)
  void* cut;         // cut_scratch bytes for the largest such cut
};

size_t run_scratch(void* base, int B, int nf, int n_docs, int k,
                   RunScratch* s) {
  auto up = [](size_t n) { return (n + 255) & ~size_t(255); };
  const int keep = max(nf > CUT_SHARED_MAX ? n_docs : 0,
                       n_docs > CUT_SHARED_MAX ? k : 0);
  const size_t a = up((size_t)B * nf * 4), c = up((size_t)B * n_docs * 4);
  if (s != nullptr) {
    char* p = static_cast<char*>(base);
    *s = {reinterpret_cast<float*>(p), reinterpret_cast<float*>(p + a),
          keep ? p + a + c : nullptr};
  }
  return a + c + (keep ? cut_scratch(nullptr, B, keep, nullptr) : 0);
}

// All passes on cs_t (B, n_c, n_q) of T; the operands as in
// pqinter_batched.
template <typename T>
int run(const T* cs_t, const float* lut2, int terms, const int32_t* codes,
        const uint8_t* res, const int32_t* lens, const uint8_t* qmask,
        const uint8_t* doc_pass, int B, int nf, int cap, int n_c, int n_q,
        int m, int ksub, float th_r, int use_filter, int n_docs, int k,
        float* scores, int32_t* pos, int32_t* sel2, float* sbar,
        void* scratch, cudaStream_t st) {
  RunScratch rs;
  run_scratch(scratch, B, nf, n_docs, k, &rs);
  emvb::Eq56Plan plan;
  cudaError_t err =
      eq56_plan<T>(res, B, n_docs, n_q, m, ksub, 0, &plan);
  if (err != cudaSuccess) return err;
  if (terms != plan.terms) return cudaErrorInvalidValue;  // the LUT's layout
  const emvb::SbarLaunch s = emvb::sbar_launch(cs_t, B, nf, cap, n_q);
  emvb::with_sbar_lanes(s.lanes, [&](auto lp) {
    sbar_kernel<decltype(lp)::value>
        <<<s.grid, emvb::SBAR_WARPS * 32, 0, st>>>(
            cs_t, codes, lens, qmask, nf, cap, n_c, n_q, s.split, rs.sbar_all);
  });
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const Cut1Key key1{rs.sbar_all, doc_pass, nf};
  const Cut1Emit emit1{rs.sbar_all, doc_pass, nf, n_docs, sel2, sbar};
  if (nf <= CUT_SHARED_MAX) {
    const CutLaunch c1 = cut_launch(B, nf);
    select1_kernel<<<c1.grid, c1.threads,
                     c1.P * sizeof(unsigned long long), st>>>(key1, c1.P,
                                                              c1.sort, emit1);
    err = cudaGetLastError();
  } else {
    err = cut_any(key1, B, nf, n_docs, emit1, rs.cut, st);
  }
  if (err != cudaSuccess) return err;
  if ((err = eq56_pass(plan, cs_t, lut2, codes, res, lens, qmask, sel2, B,
                       nf, cap, n_c, n_q, m, ksub, th_r, use_filter, n_docs,
                       rs.score2, st)) != cudaSuccess)
    return err;
  const int filtered = doc_pass != nullptr;
  const Cut2Key key2{rs.score2, n_docs};
  const Cut2Emit emit2{rs.score2, sel2, n_docs, k, filtered, scores, pos};
  if (n_docs <= CUT_SHARED_MAX) {
    const CutLaunch c2 = cut_launch(B, n_docs);
    select2_kernel<<<c2.grid, c2.threads,
                     c2.P * sizeof(unsigned long long), st>>>(key2, c2.P,
                                                              c2.sort, emit2);
    return cudaGetLastError();
  }
  return cut_any(key2, B, n_docs, k, emit2, rs.cut, st);
}

}  // namespace

extern "C" {

// Bytes of device scratch pqinter_batched needs.
size_t pqinter_scratch_bytes(int B, int nf, int n_docs, int k) {
  return run_scratch(nullptr, B, nf, n_docs, k, nullptr);
}

// T, the terms a group of the LUT layout flat_lut makes: the Eq. 5/6
// cluster pass's, or n_q (one group) where its L2 form runs.
int pqinter_lut_terms(int n_q, int m, int ksub) {
  const int t = emvb::eq56_terms(n_q, m, ksub);
  return t > 0 ? t : n_q;
}

// The plan of the Eq. 5/6 pass of a pqinter_batched launch over B queries'
// n_docs winners with these residual codes, as 10 numbers: cluster_form,
// terms, groups, cluster, passes, rows, runs, clusters, smem, staged_bytes
// (emvb::Eq56Plan).
int pqinter_eq56_plan(int cs_bf16, const uint8_t* res, int B, int n_docs,
                      int n_q, int m, int ksub, int runs, long long* out) {
  emvb::Eq56Plan p;
  const cudaError_t err =
      cs_bf16 ? eq56_plan<__nv_bfloat16>(res, B, n_docs, n_q, m, ksub, runs,
                                         &p)
              : eq56_plan<float>(res, B, n_docs, n_q, m, ksub, runs, &p);
  const long long v[10] = {p.cluster_form, p.terms,  p.groups,
                           p.cluster,      p.passes, p.rows,
                           p.runs,         p.clusters, p.smem,
                           p.staged_bytes};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return err;
}

// All pointers are device pointers; qmask may be null (every term live),
// doc_pass too (every survivor passes). cs_t (B, n_c, n_q) f32, or bf16
// when cs_bf16; th_r rounded to the CS type; lut2 (B, G, rows, terms) f32,
// flat_lut's layout of `terms` (pqinter_lut_terms); codes (B, nf, cap) i32;
// res (B, nf, cap, m) u8; lens (B, nf) i32; qmask (B, n_q) u8; doc_pass
// (B, nf) u8. Outputs: scores/pos (B, k), sel2/sbar (B, n_docs).
// scratch: the bytes pqinter_scratch_bytes gives, 256-byte aligned.
int pqinter_batched(const void* cs_t, int cs_bf16, const float* lut2,
                    int terms, const int32_t* codes, const uint8_t* res,
                    const int32_t* lens, const uint8_t* qmask,
                    const uint8_t* doc_pass, int B, int nf, int cap, int n_c,
                    int n_q, int m, int ksub, float th_r, int use_filter,
                    int n_docs, int k, float* scores, int32_t* pos,
                    int32_t* sel2, float* sbar, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_cs(cs_t, cs_bf16, [&](auto p) {
    return run(p, lut2, terms, codes, res, lens, qmask, doc_pass, B, nf, cap,
               n_c, n_q, m, ksub, th_r, use_filter, n_docs, k, scores, pos,
               sel2, sbar, scratch, st);
  });
}

}  // extern "C"
