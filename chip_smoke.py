#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, and serves ``retrieve`` at the
full widths of the ``emvb-msmarco`` config (``src/repro/configs/
emvb_msmarco.py``) on a planted synthetic index. Every phase prints one JSON
line; a failing phase raises, so the script exits non-zero and prints no
result. It needs a CUDA card and fails without one.

Two lanes of ``retrieve`` run: the fused one (the default kernel config:
the prefilter and pqinter megakernels) and the unfused one
(``fused_prefilter=False, fused_late_interaction=False``: bitpack,
bitfilter, cinter and pqscore, with the selections between them in torch).
Each lane also serves filtered retrieval (a predicate plane on the index, a
compiled ``doc_filter``) and compact candidate mode (``cand_cap`` 4096),
which give the prefilter its plan and per-query codes, pqinter its
``doc_pass`` and bitfilter its per-query codes.

Phases:
  1. device  — the card's name and power limit (nvidia-smi), torch, TF32 off
  2. build   — one nvcc per kernel source, all started together
  3. small   — each of the six kernels == its plain version, exactly, on
               small, ragged, tie-heavy inputs with dead query terms, at B in
               {1, 3, 32} and th_r None and set, then on the stress cases
               (PREFILTER_STRESS, PQINTER_STRESS: sparse, dense and shared
               candidacy (the prefilter's sparse and dense forms), cap 80
               and 200 with edge lengths, ties across tiles, a tile plus
               one doc, cuts ranked and sorted, cuts past the old caps
               (n_filter 12,000 and the whole of 20,003 docs; pqinter's
               radix select over 4,097 to 20,000 survivors keeping 1 to
               10,000), m in {4, 5, 8, 16, 32}
               (all but 16 on the serial path), odd K, Eq. 6 with no kept
               token; each with and without a term mask;
               BITFILTER_STRESS: word tables whose rows are lit at 2 %,
               none or all, at B in {1, 3, 17, 32, 40}, n_c no multiple
               of 32, cap 80 with edge lengths, cap 200 with lengths at
               the edges of 128-code rounds, and n_c above the occupancy
               bitmap's shared-memory limit; PQSCORE_STRESS: lengths at
               the edges of the 8-warp token split, one query over 4096
               docs, cap 200, m = 16 and the serial m = 5 and 8, Eq. 6
               with no kept token; in both PQ stress sets the Eq. 5/6
               cluster pass's edges: n_q 1 to 32 (clusters of 1 to 4
               CTAs of 8 terms, ragged last groups), T = 4 (m 32, a
               cluster of 8) and T = 2 (m 64, two groups a CTA), the L2
               form (m 256), caps 33 and 200, lengths at the token slots'
               edges, one doc, 10,000 docs, B up to 40; CINTER_STRESS:
               the S̄ pass that cinter and pqinter share, at n_q in
               {1, 4, 7, 8, 12, 16, 32} (both of its forms), on an
               aligned CS^T and one element off, B in {1, 3, 32, 40}
               (a doc split over up to 8, 4, 2 and 1 warps), cap in
               {10, 33, 80, 200} with lengths at the split's and the
               rounds' edges; the nq4_cap1 cases of
               each: MIND x EMVB's operands, n_q = 4 and one token a doc,
               the 4-bit words' massive F ties, sparse, dense and shared
               candidacy, n_filter 4096, n_docs 1024, th_r None); the
               filtered and compact forms
               (FILTER_CASES: plans passing 0, 1, 50 and 100 % of docs and
               one with forbidden bits and bit 31; per-query codes at B in
               {1, 3, 32, 40}, cand_cap 4100 (no multiple of the 1024-doc
               tile), holes in the valid slots; doc_pass with every, no,
               fewer than n_docs and fewer than k survivors passing)
  3b. distributed_two_ranks — two ranks spawned on the one card over gloo
               (NCCL refuses two ranks on one device), each with a planted
               index of DIST_DOCS docs: shard_index + make_shardmap_retriever
               at B = 32 and B = 1 equal to the two-level top-k composed on
               the card from each shard's retrieve and topk; run while
               nothing else is resident
  3c. recsys — the recommender and graph families at their configs'
               widths, before the planted index loads (DCN's full-vocabulary
               Adagrad step peaks at 65 GB), each model freed before the
               next; every training's loss falls and a run resumed from a
               checkpoint equals the continuous one bit for bit. MIND (1M
               items x 64, 4 interests) trained 50 AdamW steps at batch
               4,096, its item table indexed by build_index (2^14
               centroids, PQ 16 x 8 bits, one token an item) and 32 users
               and 8 single users served through EMVB at n_q = 4,
               th_r = None on both lanes with launch counts, each of the
               six kernels held against its plain version, beside exact
               MaxSim (top-10 overlap, score ratio, ms); DCN-v2 at the full
               Criteo-1TB vocabularies (187,767,399 rows x 16) trained 10
               Adagrad steps at batch 65,536, forward ms at batch 512 and
               262,144; DLRM with PQ tables at the full vocabularies
               (forward ms) and trained on float32 tables capped at 2^21
               rows a field; DIEN at its full config; GCN at minibatch_lg
               (Reddit's sizes, the sampler on a synthetic neighbour table
               on the card), full_graph_sm (Cora's) and molecule
  3d. lm    — the LM serving path, no hand-written kernel on it (its
               launch counts read around the phase: all 0), run while
               nothing else is resident: granite-moe-1b-a400m at its full
               config (24 layers, bf16, 32 experts top-8, weights from a
               seed): prefill at B = 2 x 32,768 (the chunked attention and
               the capacity gather), 32 greedy decode steps into a cache
               padded to 32,800, decode at B = 32 over a 32,768-position
               cache filled from a seed (51.5 GB); ms, tokens/s, FLOP/s
               against the bf16 dense peak, decode ms beside its byte
               bound, peak memory, the share of token-expert assignments
               dropped by capacity; the prefill and the decode steps run
               twice, bit-equal; qwen2.5-3b's widths at 4 layers, float32:
               prefill at 8,192 (chunked) then 16 decode steps, each step's
               logits == forward's at rtol 1e-4 with equal argmax; the
               granite and kimi smoke configs on the card == on the CPU
               (rtol 1e-5, the same routed expert ids), grouped == gather
               dispatch at ample capacity; their smoke trainers 20 steps,
               loss falling, resumed at step 10 bit-equal
  3e. dryrun — every (architecture x shape) cell of the registry on both
               production meshes reckoned a chip on meta (84 records:
               argument, temporary and peak bytes, FLOPs, HBM and
               collective bytes, the H100 roofline; FITS in the card's
               memory), no card memory taken; then on the 1 x 1 mesh with
               real tensors at full width, each held against its
               reckoning (argument bytes exactly, FLOPs on the card == on
               meta, peak and ms beside the reckoned peak and bound):
               granite-moe-1b-a400m long_500k (one decode step over a
               524,288-token cache), dcn-v2 serve_p99 at the Criteo-1TB
               vocabularies, gcn-cora full_graph_sm (a train step), and
               granite train_4k cut to the largest batch whose reckoned
               peak is under TRAIN_PEAK_CAP, two steps run twice, bit-equal
  4. full    — the planted index on the card at MS MARCO width; retrieve at
               B = 32 and B = 1 on each lane (launch counts read around those
               runs only); each kernel held against its plain version on the
               same operands; unfused == fused ids and score bits on the same
               CS and LUT; the candidate funnel, with the word table's lit
               rows (rho: the share of the corpus' valid tokens whose
               centroid's row has a bit set) and Eq. 6's term filter over
               the phase-3 winners (scored_term_fraction and the share of
               (doc, term) pairs keeping a token) at B = 32 and B = 1;
               the planted docs' Success@100 and MRR@10 on both lanes
  4b. invariance — the CS and LUT elements that differ between B rows of
               a batch of B and the same rows of a batch of 32 (its first
               and its last B), B in {1, 2, 4, 8, 16, 17}, at 512, 4,096 and
               2^18 centroids, float32 and bf16: all 0; beside them the
               counts and ms of one product over the whole batch
  5. filter  — the same index with a predicate plane built on the card
               from a seed (four predicates passing 50, 10, 1 and 0.01 % of
               docs); retrieve at B = 32 and B = 1 on both lanes with the
               1 % filter, the 0.01 % one (fewer than k passing candidates:
               fillers), in compact mode (cand_cap 4096) and compact with
               the 1 % filter, launch counts read around each; each kernel
               held against its plain version on the same operands; every
               finite-scored result passes the filter; unfused == fused on
               the finite entries with the same CS and LUT
  5b. timeline — two generations of raw passages encoded on the card
               against the index, held against the CPU encode;
               retrieve_timeline on both lanes, held per generation; a
               merge, a save/load round trip, ms per generation count
  5c. index_build — build_index on the card at the emvb-msmarco widths
               (2^18 centroids, PQ 16 x 8 bits, k-means 4 iterations, a PQ
               sample of 65,536) over BUILD_DOCS raw passages, each stage
               timed, k-means iterations beside their float32 floor; then
               retrieve on both lanes of the trained index at B = 32 and
               B = 1 with planted queries and launch counts, each kernel
               held against its plain version, Success@100 and MRR@10, rho
               beside the planted index's; BUILD_HOLD docs encoded again on
               the CPU against the trained codebooks, equal but for
               near-ties; k-means' update twice on the card, bit-equal
  5d. serving — RetrievalService over the timeline: planted queries of 8
               to 32 terms submitted one at a time, cold and warm, every
               ticket == retrieve_timeline on its padded batch, launch
               counts read around that traffic; a query's row in a B = 16
               flush against B = 1 and a padded miss lane, differences
               counted; a filtered batch; a hot swap staged behind pending
               tickets; add_passages; MaintenanceRunner's merge (results
               equal before and after under lossless budgets) and its
               re-epoch of a drifted generation with 2^18-centroid
               codebooks built on the card; every row the same in any
               batch, and a batch mixing cached rows of other batches with
               new queries equal to an uncached run of it; latencies,
               cache, the exposition linted
  5e. explain — explain on a planted query at full width on both lanes,
               unfiltered, with the 1 % filter and in compact mode, and
               explain_timeline over the timeline: each top-k equal to
               retrieve's (retrieve_timeline's), contributions summing to
               k, the funnel counts and phase ms
  5f. distributed — the sharded plan over one NCCL rank at full width:
               equal to retrieve at B = 32 and B = 1 (launch counts read
               around those calls), make_timeline_retriever equal to
               retrieve_timeline, make_service equal to RetrievalService
  5h2. dryrun_retrieval — the emvb-msmarco cells serve_b32 and serve_b1
               on the 1 x 1 mesh over the planted index: the cell's step
               (the sharded plan at one NCCL rank, the fused kernels) equal
               to retrieve in ids and score bits, launches counted, held
               against the reckoning as in 3e
  5g. plaid  — 22.6 GB of b = 2 PLAID residuals made on the card for the
               full index; PLAID retrieve and its four phases at B = 32 and
               B = 1 (cinter launched once a query over all 8,841,823 docs,
               held exactly against its plain version on the first 65,536
               docs and every selected doc), planted Success@100 and
               MRR@10, ms per phase and end to end beside EMVB fused in
               turns; then PLAID and EMVB on the trained index, MRR@10
  5i. encoder — the ColBERT encoder (colbert.make_config() defaults,
               float32) trained 200 AdamW steps on token pairs over the
               whole vocabulary (ENCODER), resumed from a checkpoint at
               step 100 in a fresh Trainer and held against the
               continuous run, then 20 JMPQ steps; 32,768 passages
               encoded and indexed by build_index at the emvb-msmarco
               widths (BUILD); 64 planted queries encoded and served on
               both lanes at B = 32 and B = 1 with launch counts, each
               kernel held against its plain version, MRR@10 beside exact
               MaxSim; the encoder's ms, tokens/s, peak memory and FLOP/s
               share at the default and ColBERTv2 widths (float32, bf16)
               beside fused retrieve; the embedding elements that differ
               between a batch of B in {1, 16, 17, 32} and of 32; a
               profile of a B = 32 encode and a training step
  6. timing  — CUDA-event medians of every step of both lanes (the CS^T
               transpose a step of its own), end to end, each kernel
               beside its plain version and its bound, and the host ms of
               the prefilter, pqinter, bitpack and cinter wrappers; the
               filtered and compact kernel forms and retrieve end to end
  6b. bf16   — bf16 CS (cs_dtype="bfloat16", paper §6): each of the five
               kernels with a CS operand (prefilter, pqinter, bitpack,
               cinter, pqscore) == its plain version in its bf16 form on the
               small phase's cases (CS entries equal to bf16(th) and
               bf16(th_r), S̄ ties across blocks; bitfilter on words from a
               bf16 bitpack) and at full width at B = 32 and B = 1;
               retrieve on both lanes, unfiltered, with the 1 % filter and
               in compact mode, launch counts read around each, planted
               Success@100 on both lanes, each lane held step by step; the
               lanes' differences counted, each traced to an entry equal to
               bf16(th) (the unfused bitpack compares in float32); each bf16
               form's ms, plain ms, bound (2 bytes a CS element) and the
               fused lane's steps, and retrieve's ms per config and lane
  7. limits  — kernels off the default config, each held against its plain
               version and timed by pass: the prefilter and pqinter
               megakernels on a B = 32 batch whose queries share candidates
               and at larger cuts (n_filter 1024 to 65,536; pqinter over
               4096 survivors keeping 256 and 4096 and over 20,000 keeping
               10,000: the radix select); bitfilter on
               dense word tables (th lowered until rho is about 50 % and
               100 %, B = 32 and B = 1); pqscore over 4096 winners a query;
               each pqinter and pqscore case with its Eq. 5/6 plan
               (eq56_plan: form, T, cluster size, runs a query and docs a
               run, clusters, LUT bytes staged)
  7b. budgets — the two configurations the reference's benchmarks run
               past the old shared-memory caps, on the full-width index:
               fig9's post-filter lane (n_filter 20,000, n_docs = k =
               10,000) at B = 32 and 1, float32 and bf16 CS and with the
               1 % filter, and fig2's no-prefilter baseline (n_filter = all
               8,841,823 docs, n_docs 128, k 100, th -1, th_r None) at
               B = 1: retrieve fused == unfused (finite entries with the
               filter; bf16 differences traced to entries equal to
               bf16(th)), each fused kernel == its plain version (pqinter
               two queries at a time; not at fig2's survivors) and composed
               to retrieve; ms, per-pass device ms, launches, peak memory
               and bounds per case, pqinter's Eq. 5/6 plan and the term
               filter's shares over the winners (term_filter_shares)
  8. profile — torch.profiler over retrieve on both lanes at B = 32 and
               B = 1: the device's busy share, device time and launches by
               CUDA kernel, and each hand-written kernel's __global__
               launches per wrapper call, with the Eq. 5/6 plan of the
               lane's pqinter or pqscore (tables in OUT_DIR, one
               profile_<lane>_b<B>.txt each)
  8b. examples — the port's four examples (examples/quickstart_torch.py,
               streaming_index_torch.py, retrieval_service_torch.py,
               serve_retrieval_torch.py: eight gloo ranks on the card) at
               their default sizes, each one's checks held
  9. kernels — one JSON line describing the six kernels, each with its
               operand forms and its launches on every path
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# The emvb-msmarco config (src/repro/configs/emvb_msmarco.py:12-28).
WIDTHS = dict(n_docs=8_841_823, cap=80, d=128, n_centroids=1 << 18, m=16,
              nbits=8, list_cap=4096)
MIN_LEN = 54          # lengths uniform in [54, 80]: MS MARCO's mean of ~67
ENGINE = dict(n_q=32, nprobe=4, th=0.4, th_r=0.5, n_filter=1024, n_docs=256,
              k=100)
N_QUERIES = 64        # two B = 32 batches
N_SINGLE = 8          # B = 1 queries
SUCCESS_FLOOR = 0.9

# H100 SXM data-sheet peaks (no measurement): HBM rate, float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# bf16 CS (phase bf16): th = 0.4 and th_r = 0.3 round to these bf16 values,
# above their float32 values, so an entry equal to one of them compares
# otherwise in bf16 than in float32 (the fused prefilter compares in bf16,
# the unfused bitpack in float32).
BF16_TH, BF16_TH_R = 0.4, 0.3
BF16_EDGES = (0.400390625, 0.30078125)

RECORD: dict = {}


def emit(phase: str, **fields) -> None:
    """Print one phase line and keep it for chiprun_out/chip_smoke.json."""
    RECORD[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _import_port():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)


# --- 1. device ---------------------------------------------------------------

def device_phase() -> dict:
    """Phase 1: refuse to run without CUDA; print the card and torch; TF32
    off. -> the device record of the last line."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs the port on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=smi, **dev, torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return dev


# --- 2. build ----------------------------------------------------------------

def build_phase() -> None:
    """Phase 2: build every kernel source with nvcc, all at once."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all(verbose=True)
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(paths),
         flags=_build.NVCC_FLAGS)


# --- 3. kernel == plain at small shapes --------------------------------------

def _exact(got, want) -> float:
    """Max |kernel - plain| over the outputs; raises unless every output is
    bit-identical (float32 compared by bits)."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"kernel output {g.dtype}{tuple(g.shape)} "
                                 f"vs plain {w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
        same = (torch.equal(g.view(torch.int32), w.view(torch.int32))
                if g.dtype == torch.float32 else torch.equal(g, w))
        if not same:
            raise AssertionError(f"kernel differs from its plain version "
                                 f"(max abs err {err})")
    return err


def _quant(rng, shape, scale, levels):
    import numpy as np
    x = np.round(rng.normal(size=shape) * scale * levels) / levels + 0.0
    return x.astype(np.float32)


# Stress cases of the small phase, each held exactly like the cases above.
# Lengths at cap 80 and 200 are drawn from STRESS_LENS (a 32-token round's
# edges, and the prefilter's 128-token chunk's); the prefilter's tile is
# 1024 docs.
STRESS_LENS = {80: (0, 1, 31, 32, 33, 80), 200: (0, 127, 128, 129, 200)}
PREFILTER_STRESS = (
    # name, B, n_c, n_docs, cap, n_filter, bitmap density, kind, n_q
    ("sparse_candidacy", 32, 700, 5003, 17, 300, 0.02, "", 32),
    ("dense_candidacy", 32, 700, 3001, 17, 300, 0.9, "", 32),
    ("dense_candidacy_odd_batch", 21, 700, 3001, 17, 300, 0.97, "", 32),
    ("one_candidate_set", 32, 700, 3001, 17, 300, 0.3, "shared", 32),
    ("cap80_edge_lengths", 3, 700, 2100, 80, 300, 0.3, "", 32),
    ("ties_across_tiles", 3, 64, 4100, 12, 2500, 0.9, "flat", 32),
    ("ties_b32", 32, 64, 4100, 12, 2500, 0.9, "flat", 32),
    ("tile_plus_one_docs", 1, 700, 1025, 17, 1025, 0.3, "", 32),
    ("cap200_two_chunks", 32, 700, 2100, 200, 300, 0.6, "", 32),
    # cuts past the old 8,192 cap: the whole corpus, and B = 32
    ("whole_corpus_cut", 3, 700, 20_003, 12, 20_003, 0.5, "", 32),
    ("past_old_cap_b32", 32, 700, 20_003, 12, 12_000, 0.5, "", 32),
    # MIND x EMVB (recsys phase): 4 interest terms, one token an item
    ("nq4_cap1_sparse", 32, 2048, 200_003, 1, 4096, 0.01, "", 4),
    ("nq4_cap1_dense", 32, 2048, 20_003, 1, 4096, 0.6, "", 4),
    ("nq4_cap1_shared", 32, 2048, 50_003, 1, 4096, 0.1, "shared", 4),
    ("nq4_cap1_b1", 1, 2048, 200_003, 1, 4096, 0.01, "", 4),
    ("nq4_cap1_flat_ties", 3, 64, 9001, 1, 4096, 0.9, "flat", 4),
)
PQINTER_STRESS = (
    # name, B, n_c, n_filter, cap, m, K, n_docs, k, th_r values, n_q
    ("m16_cap80_edge_lengths", 3, 700, 700, 80, 16, 256, 90, 25,
     (None, 0.25), 32),
    ("odd_m_and_K", 3, 700, 300, 17, 5, 7, 60, 20, (None, 0.25), 32),
    ("m8_cap33", 2, 300, 200, 33, 8, 16, 50, 10, (0.25,), 32),
    ("m4", 2, 300, 200, 12, 4, 16, 50, 10, (0.25,), 32),
    ("m32", 2, 300, 200, 12, 32, 16, 50, 10, (0.25,), 32),
    # cuts of more than 4,096 keys: the radix select, ranked by one block's
    # sort (B x n_keep > 65,536), by counting, and keeping one key
    ("radix_select_sorted", 32, 700, 8192, 10, 16, 16, 5000, 4500, (0.25,),
     32),
    ("radix_select_counted", 3, 700, 20_000, 10, 16, 16, 10_000, 10_000,
     (None, 0.25), 32),
    ("radix_select_keep_one", 2, 700, 4097, 10, 16, 16, 1, 1, (0.25,), 32),
    ("eq6_no_kept_token", 3, 700, 300, 17, 16, 256, 60, 20, (100.0,), 32),
    ("sorted_cuts", 32, 300, 2100, 12, 4, 16, 2100, 50, (0.25,), 32),
    ("nq4_cap1_m16", 32, 2048, 4096, 1, 16, 256, 1024, 10, (None, 0.25),
     4),
    ("nq4_cap1_m16_b1", 1, 2048, 4096, 1, 16, 256, 1024, 10, (None,), 4),
    # the Eq. 5/6 cluster pass: T = 8 terms a CTA in clusters of 1 to 4
    # (multicast rings), one term (T = 1), ragged last groups, codes read
    # from global memory (cap 33 and 200), T = 4 (C = 8), T = 2 (two groups
    # a CTA in turn), the L2 form (m * K past shared memory), one doc
    ("cluster_nq1", 3, 700, 300, 80, 16, 256, 60, 20, (None, 0.25), 1),
    ("cluster_nq7_b40", 40, 700, 300, 80, 16, 256, 256, 20, (0.25,), 7),
    ("cluster_nq9_b32", 32, 700, 300, 80, 16, 256, 256, 20, (0.25,), 9),
    ("cluster_nq17_m5", 3, 700, 300, 80, 5, 256, 60, 20, (None, 0.25), 17),
    ("cluster_nq24_cap33", 3, 700, 300, 33, 16, 256, 60, 20, (0.25,), 24),
    ("cluster_cap200", 3, 700, 300, 200, 16, 256, 60, 20, (0.25,), 32),
    ("cluster_m32_t4", 3, 700, 300, 80, 32, 256, 60, 20, (0.25,), 32),
    ("cluster_m64_t2_passes", 2, 700, 200, 80, 64, 256, 50, 10, (0.25,), 32),
    ("l2_form_m256", 2, 700, 100, 10, 256, 256, 30, 10, (0.25,), 32),
    ("cluster_one_doc_b1", 1, 700, 300, 80, 16, 256, 1, 1, (0.25,), 32),
)
# bitfilter's score pass gathers only the word rows with a bit set (its
# occupancy bitmap: in shared memory up to n_c = 319,488 at B = 32 and
# 1,368,064 at B = 1, else in global memory), streaming a group of 32 docs'
# codes 128 at a time. Lengths: a round's edges.
ROUND_LENS = (0, 1, 31, 32, 33, 127, 128, 129, 192, 193, 200)
BITFILTER_STRESS = (
    # name, B, n_c, n_docs, cap, share of lit rows, lengths, n_q
    ("lit_rows_2pct_b1", 1, 1001, 3001, 80, 0.02, STRESS_LENS[80], 32),
    ("lit_rows_2pct_b3", 3, 1001, 3001, 80, 0.02, STRESS_LENS[80], 32),
    ("lit_rows_2pct_b17", 17, 1001, 3001, 80, 0.02, STRESS_LENS[80], 32),
    ("lit_rows_2pct_b32", 32, 1001, 3001, 80, 0.02, STRESS_LENS[80], 32),
    ("lit_rows_2pct_b40", 40, 1001, 3001, 80, 0.02, STRESS_LENS[80], 32),
    ("no_lit_row_b1", 1, 1001, 3001, 80, 0.0, None, 32),
    ("no_lit_row_b32", 32, 1001, 3001, 80, 0.0, None, 32),
    ("every_row_lit_b1", 1, 1001, 3001, 80, 1.0, None, 32),
    ("every_row_lit_b3", 3, 1001, 3001, 80, 1.0, None, 32),
    ("every_row_lit_b32", 32, 1001, 3001, 80, 1.0, None, 32),
    ("cap200_rounds", 32, 1001, 2100, 200, 0.3, ROUND_LENS, 32),
    ("cap200_rounds_b1", 1, 1001, 2100, 200, 0.3, ROUND_LENS, 32),
    ("occupancy_in_global_b1", 1, 1_500_001, 3001, 80, 0.02, None, 32),
    ("occupancy_in_global_b32", 32, 600_001, 3001, 80, 0.02, None, 32),
    ("nq4_cap1_b32", 32, 16384, 100_003, 1, 0.02, None, 4),
    ("nq4_cap1_b1", 1, 16384, 100_003, 1, 0.02, None, 4),
)
# pqscore's L2 form splits a doc's tokens over 8 warps: lengths at that
# split's edges; its cluster pass reads 32 / T tokens a warp load, two loads
# a round: lengths at those edges for T = 8, 4, 2 and 1.
SPLIT_LENS = (0, 1, 7, 8, 9, 79, 80)
SLOT_LENS = (0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 79,
             80)
PQSCORE_STRESS = (
    # name, B, n_c, docs, cap, m, K, lengths, th_r values, n_q
    ("m16_split_edges_b32", 32, 700, 300, 80, 16, 256, SPLIT_LENS,
     (None, 0.25), 32),
    ("m16_b1_4096_docs", 1, 700, 4096, 80, 16, 256, None, (0.25,), 32),
    ("m16_cap200", 3, 700, 200, 200, 16, 256, None, (None, 0.25), 32),
    ("m5_serial", 3, 700, 300, 80, 5, 256, SPLIT_LENS, (None, 0.25), 32),
    ("m8_serial", 3, 700, 300, 80, 8, 16, SPLIT_LENS, (0.25,), 32),
    ("m16_eq6_no_kept_token", 3, 700, 300, 80, 16, 256, SPLIT_LENS,
     (100.0,), 32),
    ("nq4_cap1_m16_b32", 32, 2048, 1024, 1, 16, 256, None, (None, 0.25),
     4),
    ("nq4_cap1_m16_b1", 1, 2048, 1024, 1, 16, 256, None, (None,), 4),
    # the Eq. 5/6 cluster pass, as in PQINTER_STRESS
    ("cluster_nq1", 3, 700, 300, 80, 16, 256, SLOT_LENS, (None, 0.25), 1),
    ("cluster_nq7_b40", 40, 700, 256, 80, 16, 256, SLOT_LENS, (0.25,), 7),
    ("cluster_nq8", 3, 700, 300, 80, 16, 256, SLOT_LENS, (None,), 8),
    ("cluster_nq9_b32", 32, 700, 256, 80, 16, 256, SLOT_LENS, (0.25,), 9),
    ("cluster_nq16_m8", 3, 700, 300, 80, 8, 256, SLOT_LENS, (0.25,), 16),
    ("cluster_nq17_m5", 3, 700, 300, 80, 5, 256, SLOT_LENS, (None, 0.25),
     17),
    ("cluster_nq24_cap33", 3, 700, 300, 33, 16, 256, None, (0.25,), 24),
    ("cluster_cap200", 3, 700, 200, 200, 16, 256, None, (0.25,), 32),
    ("cluster_m32_t4", 3, 700, 300, 80, 32, 256, SLOT_LENS, (0.25,), 32),
    ("cluster_m64_t2_passes", 2, 700, 60, 80, 64, 256, SLOT_LENS, (0.25,),
     32),
    ("l2_form_m256", 2, 700, 40, 10, 256, 256, None, (0.25,), 32),
    ("cluster_one_doc", 1, 700, 1, 80, 16, 256, None, (0.25,), 32),
    ("cluster_10000_docs_b32", 32, 700, 10_000, 12, 16, 256, None, (0.25,),
     32),
)
# The S̄ pass (emvb::sbar_block), which cinter and pqinter's pass 1 both
# run: n_q 1 and 7 run one lane per term; 4, 8, 12, 16 and 32 the 16-byte
# rows in float32 (1, 2, 4 (3 pieces), 4 and 8 lanes a row), 8, 16 and 32
# in bf16 (1, 2 and 4 lanes); each case runs again on a CS^T one element
# past 16-byte alignment (one lane per term). Docs per query such that on
# 132 SMs B = 1, 3 and 40 split a doc over up to 8, 4 and 2 warps (fewer
# where cap is short of that many rounds) and B = 32 over one; each cap
# once per n_q.
SBAR_DOCS = {1: 300, 3: 400, 32: 300, 40: 60}
SBAR_CAPS = (10, 33, 80, 200)
CINTER_STRESS = tuple(
    (f"sbar_nq{n_q}_b{nb}_cap{cap}", nb, n_q, SBAR_DOCS[nb], cap)
    for i, n_q in enumerate((1, 4, 7, 8, 12, 16, 32))
    for k, nb in enumerate(SBAR_DOCS)
    for cap in (SBAR_CAPS[(i + k) % len(SBAR_CAPS)],))


def sbar_lens(cap: int) -> tuple:
    """Token counts of the S̄ stress cases: SPLIT_LENS's edges of an 8-warp
    split and the edges of the pass's 32-, 64- and 128-token rounds, 0 and
    cap among them."""
    return tuple(sorted({n for n in (0, 1, 7, 8, 9, 31, 32, 33, 63, 64, 65,
                                     127, 128, 129, cap - 1, cap)
                         if n <= cap}))


def off_alignment(x):
    """A contiguous copy of x whose storage starts one element past a
    16-byte boundary (the S̄ pass's one-lane-per-term form)."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view

# Filtered and compact retrieval's operand forms. Plans over predicate words
# drawn with the bit rates SMALL_RATES (bit 31 in use): none, ~1 %, ~50 % and
# all of the docs pass, and one with forbidden bits.
SMALL_RATES = {0: 0.5, 1: 0.1, 2: 0.01, 3: 0.0001, 31: 0.5}
SMALL_PLANS = {"pass0": (), "pass1pct": ((1 << 2, 0),),
               "pass50pct": ((1 << 0, 0),), "pass100": ((0, 0),),
               "forbidden": ((1 << 0, 1 << 1), (1 << 31, 1 << 2))}
# per-query codes: cand_cap 4100 is no multiple of the prefilter's tile
COMPACT_CASE = dict(n_c=700, cand_cap=4100, cap=80, n_filter=1024)
# doc_pass: survivors passing, of nf = 700 with n_docs = 90 and k = 25
DOC_PASS = {"all": 700, "none": 0, "under_n_docs": 45, "under_k": 12}
FILTER_CASES = ([f"plan_{p}" for p in SMALL_PLANS]
                + ["per_query_codes_b1_3_32_40"]
                + [f"doc_pass_{p}" for p in DOC_PASS])


def predicate_words(n: int, rates: dict, seed: int, device):
    """(n,) uint32 predicate plane made on ``device`` from a seed: bit i of
    a doc's word is set with probability rates[i], each bit drawn on its
    own."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    words = torch.zeros(n, dtype=torch.int32, device=device)
    for bit, rate in rates.items():
        hit = torch.rand(n, generator=g, device=device) < rate
        words |= hit.to(torch.int32) << bit
    return words.view(torch.uint32)


def bf16_edges(seed, x, share: float = 0.15, values=BF16_EDGES):
    """``x`` (float32, every entry a bf16 value) with a ``share`` of its
    entries set to each of ``values`` (tests/torch_inputs.py holds the same
    definition for the CPU tests)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = x.copy()
    pick = rng.random(x.shape)
    for i, v in enumerate(values):
        x[(pick >= i * share) & (pick < (i + 1) * share)] = v
    return x


def _stress_lens(rng, shape, cap: int):
    """Token counts: from STRESS_LENS at its caps, else uniform in
    [0, cap]."""
    import numpy as np
    if cap in STRESS_LENS:
        return rng.choice(np.asarray(STRESS_LENS[cap], np.int32), size=shape)
    return rng.integers(0, cap + 1, size=shape).astype(np.int32)


def lit_row_words(rng, nb: int, n_c: int, share: float, n_q: int = 32):
    """(B, n_c) int32 word table of ``n_q``-bit words whose rows (a
    centroid's B words) are all zero except a ``share`` of them, each lit
    row with at least one bit set and, at n_q = 32, bit 31 in use
    (int32-negative words)."""
    import numpy as np
    w = rng.integers(0, 1 << 32, size=(nb, n_c), dtype=np.uint64)
    w &= rng.integers(0, 1 << 32, size=(nb, n_c), dtype=np.uint64)
    w &= np.uint64((1 << n_q) - 1)
    lit = rng.random(n_c) < share
    cols = np.flatnonzero(lit)
    w[cols % nb, cols] |= np.uint64(1) << (cols % n_q).astype(np.uint64)
    w[:, ~lit] = 0
    return w.astype(np.uint32).view(np.int32)


def small_phase(dev, cs_dtype: str = "float32") -> dict:
    """Phase 3: each kernel against its plain version on small, ragged,
    tie-heavy inputs. -> max abs error per kernel (0: exact). With
    ``cs_dtype="bfloat16"`` (the bf16 phase) the CS operands are bf16, with
    a share of entries equal to bf16(th) and bf16(th_r), and th and th_r
    are BF16_TH and BF16_TH_R."""
    import numpy as np
    import torch
    from repro_torch.kernels import bitfilter as kbf
    from repro_torch.kernels import bitpack as kbp
    from repro_torch.kernels import cinter as kci
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import pqscore as kps
    from repro_torch.kernels import prefilter as kpf
    from repro_torch.kernels import topnprobe as ktp

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    bf16 = cs_dtype == "bfloat16"
    th = BF16_TH if bf16 else 0.25

    def thr(v):
        """A stress case's th_r under this phase's CS dtype."""
        return BF16_TH_R if bf16 and v == 0.25 else v

    def c(x):
        """A CS operand in this phase's dtype."""
        return t(bf16_edges(x.size, x)).to(torch.bfloat16) if bf16 else t(x)

    err = dict.fromkeys(KERNELS, 0.0)
    cases = 0

    def hold(name, got, want):
        nonlocal cases
        err[name] = max(err[name], _exact(got, want))
        cases += 1
    for nb in (1, 3, 32):
        rng = np.random.default_rng(nb)
        n_q, n_c, n_docs, cap, n_filter = 32, 700, 5003, 17, 300
        cs = _quant(rng, (nb, n_q, n_c), 0.5, 4)
        codes = rng.integers(0, n_c, size=(n_docs, cap)).astype(np.int32)
        lens = rng.integers(0, cap + 1, size=n_docs).astype(np.int32)
        codes[np.arange(cap)[None, :] >= lens[:, None]] = n_c
        bitmap = rng.random((nb, n_docs)) < 0.3
        qm = rng.random((nb, n_q)) < 0.8
        qm[:, 0] = True
        args = (c(cs), th, t(codes), t(lens), t(bitmap), n_filter, t(qm))
        hold("prefilter", ops.prefilter_batched(*args),
             kpf.prefilter_batched_ref(*args))
        args = (c(cs), th, t(qm))
        bits = kbp.bitpack_batched_ref(*args)
        hold("bitpack", (ops.bitpack_batched(*args),), (bits,))
        args = (bits, t(codes), t(lens))
        hold("bitfilter", (ops.bitfilter_batched(*args),),
             (kbf.bitfilter_batched_ref(*args),))
        for nprobe in (1, 4, 32, 33):          # both forms of the kernel
            for q in (t(qm), None):
                args = (c(cs), th, nprobe, q)
                hold("topnprobe", (ktp.masked_topk(*args),),
                     (ktp.masked_topk_ref(*args),))

        nf, m, ksub, n_docs2, k = 700, 16, 256, 90, 25
        cs_t = _quant(rng, (nb, n_c, n_q), 0.5, 2)
        lut = _quant(rng, (nb, n_q, m, ksub), 0.1, 8)
        pcodes = rng.integers(0, n_c, size=(nb, nf, cap)).astype(np.int32)
        plens = rng.integers(0, cap + 1, size=(nb, nf)).astype(np.int32)
        pcodes[np.arange(cap) >= plens[..., None]] = n_c
        res = rng.integers(0, ksub, size=(nb, nf, cap, m)).astype(np.uint8)
        args = (c(cs_t), t(pcodes), t(plens), t(qm))
        hold("cinter", (ops.cinter_batched(*args),),
             (kci.cinter_batched_ref(*args),))
        for th_r in (None, thr(0.25)):
            args = (c(cs_t), t(lut), t(pcodes), t(res), t(plens), th_r,
                    n_docs2, k, t(qm))
            hold("pqinter", ops.pqinter_batched(*args),
                 kpq.pqinter_batched_ref(*args))
            args = (c(cs_t), t(lut), t(pcodes), t(res), t(plens), th_r,
                    t(qm))
            hold("pqscore", (ops.pqscore_batched(*args),),
                 (kps.pqscore_batched_ref(*args),))
    for name, nb, n_c, n_docs, cap, n_filter, density, kind, n_q in (
            PREFILTER_STRESS):
        rng = np.random.default_rng(len(name) * 1000 + nb)
        cs = _quant(rng, (nb, n_q, n_c), 0.5, 4)
        if kind == "flat":           # one word per query: F ties everywhere
            cs = np.repeat(cs[:, :, :1], n_c, axis=2)
        codes = rng.integers(0, n_c, size=(n_docs, cap)).astype(np.int32)
        lens = _stress_lens(rng, n_docs, cap)
        codes[np.arange(cap)[None, :] >= lens[:, None]] = n_c
        bitmap = rng.random((nb, n_docs)) < density
        if kind == "shared":         # every query has the same candidates
            bitmap[:] = bitmap[:1]
        qm = rng.random((nb, n_q)) < 0.8
        qm[:, 0] = True
        for q in (t(qm), None):
            args = (c(cs), th, t(codes), t(lens), t(bitmap), n_filter, q)
            hold("prefilter", ops.prefilter_batched(*args),
                 kpf.prefilter_batched_ref(*args))
            hold("bitpack", (ops.bitpack_batched(c(cs), th, q),),
                 (kbp.bitpack_batched_ref(c(cs), th, q),))
        bits = kbp.bitpack_batched_ref(c(cs), th, t(qm))
        args = (bits, t(codes), t(lens))
        hold("bitfilter", (ops.bitfilter_batched(*args),),
             (kbf.bitfilter_batched_ref(*args),))
    for name, nb, n_c, nf, cap, m, ksub, n_docs2, k, th_rs, n_q in (
            PQINTER_STRESS):
        rng = np.random.default_rng(len(name) * 1000 + m)
        cs_t = _quant(rng, (nb, n_c, n_q), 0.5, 2)
        lut = _quant(rng, (nb, n_q, m, ksub), 0.1, 8)
        pcodes = rng.integers(0, n_c, size=(nb, nf, cap)).astype(np.int32)
        plens = _stress_lens(rng, (nb, nf), cap)
        pcodes[np.arange(cap) >= plens[..., None]] = n_c
        res = rng.integers(0, ksub, size=(nb, nf, cap, m)).astype(np.uint8)
        qm = rng.random((nb, n_q)) < 0.8
        qm[:, 0] = True
        for th_r in map(thr, th_rs):
            for q in (t(qm), None):
                args = (c(cs_t), t(lut), t(pcodes), t(res), t(plens), th_r,
                        n_docs2, k, q)
                hold("pqinter", ops.pqinter_batched(*args),
                     kpq.pqinter_batched_ref(*args))
                args = (c(cs_t), t(lut), t(pcodes), t(res), t(plens), th_r,
                        q)
                hold("pqscore", (ops.pqscore_batched(*args),),
                     (kps.pqscore_batched_ref(*args),))
        for q in (t(qm), None):
            args = (c(cs_t), t(pcodes), t(plens), q)
            hold("cinter", (ops.cinter_batched(*args),),
                 (kci.cinter_batched_ref(*args),))
    for name, nb, n_c, n_docs, cap, share, lens, n_q in BITFILTER_STRESS:
        rng = np.random.default_rng(len(name) * 1000 + nb)
        codes = rng.integers(0, n_c, size=(n_docs, cap)).astype(np.int32)
        lens = (rng.choice(np.asarray(lens, np.int32), size=n_docs)
                if lens else rng.integers(0, cap + 1, size=n_docs)
                ).astype(np.int32)
        codes[np.arange(cap)[None, :] >= lens[:, None]] = n_c
        args = (t(lit_row_words(rng, nb, n_c, share, n_q)), t(codes),
                t(lens))
        hold("bitfilter", (ops.bitfilter_batched(*args),),
             (kbf.bitfilter_batched_ref(*args),))
    for name, nb, n_c, nd, cap, m, ksub, lens, th_rs, n_q in PQSCORE_STRESS:
        rng = np.random.default_rng(len(name) * 1000 + m)
        cs_t = _quant(rng, (nb, n_c, n_q), 0.5, 2)
        lut = _quant(rng, (nb, n_q, m, ksub), 0.1, 8)
        pcodes = rng.integers(0, n_c, size=(nb, nd, cap)).astype(np.int32)
        plens = (rng.choice(np.asarray(lens, np.int32), size=(nb, nd))
                 if lens else rng.integers(0, cap + 1, size=(nb, nd))
                 ).astype(np.int32)
        pcodes[np.arange(cap) >= plens[..., None]] = n_c
        res = rng.integers(0, ksub, size=(nb, nd, cap, m)).astype(np.uint8)
        qm = rng.random((nb, n_q)) < 0.8
        qm[:, 0] = True
        for th_r in map(thr, th_rs):
            for q in (t(qm), None):
                args = (c(cs_t), t(lut), t(pcodes), t(res), t(plens), th_r,
                        q)
                hold("pqscore", (ops.pqscore_batched(*args),),
                     (kps.pqscore_batched_ref(*args),))
    for name, nb, n_q, nd, cap in CINTER_STRESS:
        rng = np.random.default_rng(len(name) * 1000 + n_q * 50 + nb)
        n_c, m, ksub = 300, 4, 16
        cs_t = _quant(rng, (nb, n_c, n_q), 0.5, 2)
        lut = _quant(rng, (nb, n_q, m, ksub), 0.1, 8)
        pcodes = rng.integers(0, n_c, size=(nb, nd, cap)).astype(np.int32)
        plens = rng.choice(np.asarray(sbar_lens(cap), np.int32),
                           size=(nb, nd))
        pcodes[np.arange(cap) >= plens[..., None]] = n_c
        res = rng.integers(0, ksub, size=(nb, nd, cap, m)).astype(np.uint8)
        qm = rng.random((nb, n_q)) < 0.8
        qm[:, 0] = True
        for cs_op in (c(cs_t), off_alignment(c(cs_t))):
            for q in (t(qm), None):
                args = (cs_op, t(pcodes), t(plens), q)
                hold("cinter", (ops.cinter_batched(*args),),
                     (kci.cinter_batched_ref(*args),))
                args = (cs_op, t(lut), t(pcodes), t(res), t(plens),
                        thr(0.25), min(nd, 50), 10, q)
                hold("pqinter", ops.pqinter_batched(*args),
                     kpq.pqinter_batched_ref(*args))
    for nb in (1, 3, 32):                      # plans, shared codes
        rng = np.random.default_rng(200 + nb)
        n_c, n_docs, cap = 700, 5003, 17
        cs = _quant(rng, (nb, 32, n_c), 0.5, 4)
        codes = rng.integers(0, n_c, size=(n_docs, cap)).astype(np.int32)
        lens = rng.integers(0, cap + 1, size=n_docs).astype(np.int32)
        codes[np.arange(cap)[None, :] >= lens[:, None]] = n_c
        bitmap = rng.random((nb, n_docs)) < 0.3
        qm = rng.random((nb, 32)) < 0.8
        qm[:, 0] = True
        words = predicate_words(n_docs, SMALL_RATES, nb, dev)
        for clauses in SMALL_PLANS.values():
            args = (c(cs), th, t(codes), t(lens), t(bitmap), 300, t(qm))
            kw = dict(pred_words=words, plan=clauses)
            hold("prefilter", ops.prefilter_batched(*args, **kw),
                 kpf.prefilter_batched_ref(*args, **kw))
    for nb in (1, 3, 32, 40):                  # per-query codes
        rng = np.random.default_rng(300 + nb)
        n_c, cc, cap = (COMPACT_CASE[k] for k in ("n_c", "cand_cap", "cap"))
        cs = _quant(rng, (nb, 32, n_c), 0.5, 4)
        codes = rng.integers(0, n_c, size=(nb, cc, cap)).astype(np.int32)
        lens = _stress_lens(rng, (nb, cc), cap)
        codes[np.arange(cap) >= lens[..., None]] = n_c
        valid = rng.random((nb, cc)) < 0.65
        valid[-1, :7] = False
        qm = rng.random((nb, 32)) < 0.8
        qm[:, 0] = True
        args = (c(cs), th, t(codes), t(lens), t(valid),
                COMPACT_CASE["n_filter"], t(qm))
        hold("prefilter", ops.prefilter_batched(*args),
             kpf.prefilter_batched_ref(*args))
        args = (kbp.bitpack_batched_ref(c(cs), th, t(qm)), t(codes),
                t(np.where(valid, lens, 0).astype(np.int32)))
        hold("bitfilter", (ops.bitfilter_batched(*args),),
             (kbf.bitfilter_batched_ref(*args),))
    for nb in (3, 32):                         # doc_pass
        rng = np.random.default_rng(400 + nb)
        n_c, nf, cap, m, ksub, n_docs2, k = 700, 700, 80, 16, 256, 90, 25
        cs_t = _quant(rng, (nb, n_c, 32), 0.5, 2)
        lut = _quant(rng, (nb, 32, m, ksub), 0.1, 8)
        pcodes = rng.integers(0, n_c, size=(nb, nf, cap)).astype(np.int32)
        plens = _stress_lens(rng, (nb, nf), cap)
        pcodes[np.arange(cap) >= plens[..., None]] = n_c
        res = rng.integers(0, ksub, size=(nb, nf, cap, m)).astype(np.uint8)
        qm = rng.random((nb, 32)) < 0.8
        qm[:, 0] = True
        for n_pass in DOC_PASS.values():
            dp = np.zeros((nb, nf), bool)
            for b in range(nb):
                dp[b, rng.choice(nf, size=n_pass, replace=False)] = True
            for th_r in (None, thr(0.25)):
                args = (c(cs_t), t(lut), t(pcodes), t(res), t(plens), th_r,
                        n_docs2, k, t(qm))
                hold("pqinter", ops.pqinter_batched(*args, doc_pass=t(dp)),
                     kpq.pqinter_batched_ref(*args, t(dp)))
    torch.cuda.synchronize()
    emit("small" if not bf16 else "bf16_small", cases=cases, exact=True,
         cs_dtype=cs_dtype, th=th, max_abs_err=err,
         stress=[c[0] for c in PREFILTER_STRESS + PQINTER_STRESS
                 + BITFILTER_STRESS + PQSCORE_STRESS + CINTER_STRESS],
         filter_cases=FILTER_CASES)
    return err


# --- 4. the main path at full width ------------------------------------------

def _field_bytes(index) -> dict:
    return {f: getattr(index, f).numel() * getattr(index, f).element_size()
            for f in index._fields}


def prefilter_bound(cs, index, bitmap, n_filter, doc_pass=None) -> dict:
    """Least bytes the prefilter must move on these inputs: the CS, the
    bitmap, the term mask, the lengths and valid-token codes of every doc
    that is some query's candidate, and its outputs. With a plan
    (``doc_pass``, its verdict per doc): the predicate word of every doc
    that is some query's candidate, and codes only of those that pass."""
    nb, n_q, n_c = cs.shape
    any_cand = bitmap.any(0)
    words = 0
    if doc_pass is not None:
        words = int(any_cand.sum()) * 4
        bitmap = bitmap & doc_pass
        any_cand = bitmap.any(0)
    n_cand_docs = int(any_cand.sum())
    tokens = int(index.doc_lens[any_cand].sum())
    nbytes = (cs.numel() * cs.element_size() + bitmap.numel() + nb * n_q
              + words
              + n_cand_docs * 4 + tokens * 4
              + nb * n_filter * 8 + nb * n_c * 4)
    ops_ = nb * n_q * n_c + nb * tokens          # compares + word ORs
    return _bound(nbytes, ops_)


def prefilter_query_bound(cs, lens, valid, n_filter) -> dict:
    """Least bytes the prefilter's compact form must move: the CS, the
    buffer's valid bits, the term mask, the lengths and valid-token codes of
    its valid slots, and its outputs."""
    nb, n_q, n_c = cs.shape
    tokens = int(lens[valid].sum())
    nbytes = (cs.numel() * cs.element_size() + valid.numel() + nb * n_q
              + int(valid.sum()) * 4 + tokens * 4
              + nb * n_filter * 8 + nb * n_c * 4)
    return _bound(nbytes, nb * n_q * n_c + tokens)


def _rows_touched(codes, lens, n_c: int, step: int = 1 << 20) -> int:
    """Distinct (query, centroid) rows of CS^T that the valid tokens of
    codes (B, docs, cap) touch, marked ``step`` docs at a time (fig2's
    baseline gives 8,841,823 survivors)."""
    import torch
    nb, nd, cap = codes.shape
    dev = codes.device
    tok = torch.arange(cap, device=dev)
    seen = torch.zeros(nb * n_c, dtype=torch.bool, device=dev)
    base = torch.arange(nb, device=dev)[:, None, None] * n_c
    for s in range(0, nd, step):
        valid = tok < lens[:, s:s + step, None]
        seen[(base + codes[:, s:s + step].clamp(0, n_c - 1).long())[valid]] \
            = True
    return int(seen.sum())


def pqinter_bound(cs_t, lut, codes, lens, sel2, n_docs, k,
                  doc_pass=None) -> dict:
    """Least bytes the pqinter must move on these inputs: the survivors'
    valid-token codes and lengths, the CS^T rows those tokens touch, the
    LUT, the phase-3 winners' residual codes, the term mask, the outputs.
    With ``doc_pass``: the verdicts, and tokens only of passing survivors
    (a phase-3 slot at position -1 is a filler and reads nothing)."""
    import torch
    nb, nf, cap = codes.shape
    n_c, n_q = cs_t.shape[1:]
    m = lut.shape[2]
    verdicts = 0
    if doc_pass is not None:
        lens = torch.where(doc_pass, lens, 0)
        verdicts = nb * nf
    n_rows = _rows_touched(codes, lens, n_c)
    win_tokens = int(torch.gather(lens, 1, sel2.long().clamp(min=0))[
        sel2 >= 0].sum())
    tokens = int(lens.sum())
    nbytes = (tokens * 4 + nb * nf * 4 + n_rows * n_q * cs_t.element_size()
              + lut.numel() * 4
              + win_tokens * m + nb * n_q + nb * k * 8 + nb * n_docs * 8
              + verdicts)
    ops_ = tokens * n_q + win_tokens * n_q * (m + 1)   # maxes + LUT adds
    out = _bound(nbytes, ops_)
    # the rows its Eq. 5/6 pass reads, as the L2 form gathers them: per
    # winner's valid token a CS^T row and m LUT rows of n_q floats
    out["eq56_row_bytes"] = win_tokens * (
        _sectors(n_q * cs_t.element_size()) + m * _sectors(n_q * 4))
    return out


def bitpack_bound(cs) -> dict:
    """Least bytes bitpack must move: the CS, the term mask, the words."""
    nb, n_q, n_c = cs.shape
    return _bound(cs.numel() * cs.element_size() + nb * n_q + nb * n_c * 4,
                  nb * n_q * n_c)


def topnprobe_bound(cs, nprobe: int) -> dict:
    """Least bytes topnprobe must move: the CS, the term mask, the ids; one
    compare an entry."""
    nb, n_q, n_c = cs.shape
    return _bound(cs.numel() * cs.element_size() + nb * n_q
                  + nb * n_q * nprobe * 4, nb * n_q * n_c)


def _sectors(nbytes: int) -> int:
    """Bytes of the 32-byte L2 sectors a contiguous read of nbytes takes."""
    return -(-nbytes // 32) * 32


def bitfilter_bound(nb: int, index, lit_tokens: int) -> dict:
    """Least bytes bitfilter must move: every doc's length and valid-token
    codes, the B words of every centroid, and F out; one OR per (valid
    token, query). Beside it, the L2 bytes its score pass gathers: one row
    of the transposed word table (B words) per lit token."""
    n_docs = index.codes.shape[0]
    n_c = index.centroids.shape[0]
    tokens = int(index.doc_lens.sum())
    out = _bound(n_docs * 4 + tokens * 4 + nb * n_c * 4 + nb * n_docs * 4,
                 nb * tokens)
    out["l2_gather_bytes"] = lit_tokens * _sectors(nb * 4)
    return out


def bitfilter_query_bound(bits, codes, lens) -> dict:
    """Least bytes bitfilter's compact form must move: the buffer's lengths
    and valid-token codes, the words of the distinct (query, centroid) rows
    those tokens touch, and F out; one OR per valid token."""
    nb, cc, _ = codes.shape
    tokens = int(lens.sum())
    nbytes = (nb * cc * 4 + tokens * 4
              + _rows_touched(codes, lens, bits.shape[1]) * 4 + nb * cc * 4)
    return _bound(nbytes, tokens)


def cinter_bound(cs_t, codes, lens) -> dict:
    """Least bytes cinter must move: the survivors' lengths and valid-token
    codes, the CS^T rows those tokens touch, the term mask and S̄ out; one
    max per (valid token, term). Beside it, the L2 bytes its gathers take:
    one CS^T row per valid token."""
    nb, nd, _ = codes.shape
    n_c, n_q = cs_t.shape[1:]
    tokens = int(lens.sum())
    nbytes = (nb * nd * 4 + tokens * 4 + _rows_touched(codes, lens, n_c)
              * n_q * cs_t.element_size() + nb * n_q + nb * nd * 4)
    out = _bound(nbytes, tokens * n_q)
    out["l2_gather_bytes"] = tokens * _sectors(n_q * cs_t.element_size())
    return out


def pqscore_bound(cs_t, lut, codes, lens) -> dict:
    """Least bytes pqscore must move: the winners' lengths, valid-token
    codes and residual codes, the CS^T rows those tokens touch, the LUT,
    the term mask and the scores out; m LUT adds and a max per (valid
    token, term)."""
    nb, nd, _ = codes.shape
    n_c, n_q = cs_t.shape[1:]
    m = lut.shape[2]
    tokens = int(lens.sum())
    nbytes = (nb * nd * 4 + tokens * (4 + m) + _rows_touched(codes, lens, n_c)
              * n_q * cs_t.element_size() + lut.numel() * 4 + nb * n_q
              + nb * nd * 4)
    out = _bound(nbytes, tokens * n_q * (m + 1))
    # the L2 bytes its gathers take: per valid token a CS^T row and m LUT
    # rows of n_q floats
    out["l2_gather_bytes"] = tokens * (_sectors(n_q * cs_t.element_size())
                                       + m * _sectors(n_q * 4))
    return out


def eq56_plan_of(kern: str, operands, n_docs: int = None) -> dict:
    """How the Eq. 5/6 pass of ``kern`` (pqinter over ``n_docs`` winners of
    its survivor operands, or pqscore over its winner operands) runs on
    these operands: its form (cluster or L2), T, cluster size, runs a query,
    docs a run, clusters, the LUT bytes it stages (``eq56_plan``)."""
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import pqscore as kps
    cs_t, lut, codes, res = operands[:4]
    n_q, m, ksub = lut.shape[1:]
    if kern == "pqscore":
        return kps.plan(cs_t, codes, res, n_q, m, ksub)
    return kpq.eq56_plan("pqinter", "pqinter_eq56_plan", cs_t, res, n_docs,
                         n_q, m, ksub)


def _bound(nbytes: int, n_ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": n_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def hold_phases(index, q, cfg, plain_step: int = None) -> dict:
    """One batch through the fused lane's own steps (as ``engine``'s
    ``_phase12_batch`` and ``_phase34_batch`` run them, filter and candidate
    mode included): each kernel against its plain version on the SAME CS,
    bitmap, LUT and survivor operands, CS in ``cfg.cs_dtype``; pqinter's
    ``plain_step`` queries at a time (None: the whole batch; 0: not held,
    its error None). Returns the intermediates and the composed ids."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    from repro_torch.kernels import prefilter as kpf
    from repro_torch.kernels import topnprobe as ktp
    cs = teng.centroid_scores(q, index.centroids, cfg.cs_dtype)
    bitmap = teng._candidates(index, cs, cfg)
    err_tp = _exact((ktp.masked_topk(cs, cfg.th, cfg.nprobe),),
                    (ktp.masked_topk_ref(cs, cfg.th, cfg.nprobe),))
    doc_pass = teng._doc_pass(index, cfg)
    cand_ids = None
    if cfg.candidate_mode == "compact":
        cbitmap = bitmap if doc_pass is None else bitmap & doc_pass
        cand_ids, cand_valid = teng._compact_candidates(cbitmap, cfg)
        pf_args = (cs, cfg.th, index.codes[cand_ids],
                   index.doc_lens[cand_ids], cand_valid, cfg.n_filter)
        pf_kw = {}
    else:
        pf_args = (cs, cfg.th, index.codes, index.doc_lens, bitmap,
                   cfg.n_filter)
        pf_kw = ({} if doc_pass is None else dict(
            pred_words=index.pred_words, plan=cfg.doc_filter.clauses))
    pf = ops.prefilter_batched(*pf_args, **pf_kw)
    err_pf = _exact(pf, kpf.prefilter_batched_ref(*pf_args, **pf_kw))
    sel1 = pf[1].long()
    if cand_ids is not None:
        sel1 = torch.gather(cand_ids, 1, sel1)
    lut = teng._query_lut(index, q)
    operands = teng._survivor_operands(index, cs, lut, sel1)
    pq_args = (*operands, cfg.th_r, cfg.n_docs, cfg.k)
    s1_pass = None if doc_pass is None else doc_pass[sel1]
    pq = ops.pqinter_batched(*pq_args, doc_pass=s1_pass)
    err_pq = None if plain_step == 0 else _exact(pq, plain_pqinter(
        operands, *pq_args[len(operands):], s1_pass,
        step=plain_step or q.shape[0]))
    return dict(cs=cs, bitmap=bitmap, doc_pass=doc_pass, pf_args=pf_args,
                pf_kw=pf_kw, pf=pf, sel1=sel1, lut=lut,
                operands=operands, s1_pass=s1_pass, pq=pq,
                err={"prefilter": err_pf, "pqinter": err_pq,
                     "topnprobe": err_tp},
                ids=torch.gather(sel1, 1, pq[1].long()).to(torch.int32))


def hold_unfused(index, q, cfg, h) -> dict:
    """One batch through the unfused lane's own steps (as ``engine``'s
    ``_phase1`` to ``_phase4`` run them, filter and candidate mode
    included) on the fused lane's CS, bitmap and LUT (``h``): each kernel
    against its plain version on the same operands, the phase-2 cut against
    the prefilter's on float32 CS (on bf16 CS the two lanes' bit vectors
    differ where an entry equals bf16(th): the bf16 phase accounts for
    that). Returns the intermediates and the composed result."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.core.topk import topk
    from repro_torch.kernels import bitfilter as kbf
    from repro_torch.kernels import bitpack as kbp
    from repro_torch.kernels import cinter as kci
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqscore as kps
    err = {}
    bp_args = (h["cs"], cfg.th)
    bits = ops.bitpack_batched(*bp_args)
    err["bitpack"] = _exact((bits,), (kbp.bitpack_batched_ref(*bp_args),))
    doc_pass = h["doc_pass"]
    bitmap = h["bitmap"] if doc_pass is None else h["bitmap"] & doc_pass
    cand_ids = None
    if cfg.candidate_mode == "compact":
        cand_ids, bitmap = teng._compact_candidates(bitmap, cfg)
        bf_args = (bits, index.codes[cand_ids], torch.where(
            bitmap, index.doc_lens[cand_ids], 0))
    else:
        bf_args = (bits, index.codes, index.doc_lens)
    f = ops.bitfilter_batched(*bf_args)
    err["bitfilter"] = _exact((f,), (kbf.bitfilter_batched_ref(*bf_args),))
    sel1 = topk(torch.where(bitmap, f, torch.full_like(f, -1)),
                cfg.n_filter)[1]
    if cand_ids is not None:
        sel1 = torch.gather(cand_ids, 1, sel1)
    if cfg.cs_dtype == "float32" and not torch.equal(sel1, h["sel1"]):
        raise AssertionError("the unfused phase-2 cut differs from the "
                             "prefilter megakernel's")
    cs_t = teng._transposed(h["cs"])
    ci_args = (cs_t, index.codes[sel1], index.doc_lens[sel1])
    sbar = ops.cinter_batched(*ci_args)
    err["cinter"] = _exact((sbar,), (kci.cinter_batched_ref(*ci_args),))
    if doc_pass is not None:
        sbar = torch.where(doc_pass[sel1], sbar, -torch.inf)
    sel2 = torch.gather(sel1, 1, topk(sbar, cfg.n_docs)[1])
    ps_args = (cs_t, h["lut"], index.codes[sel2], index.res_codes[sel2],
               index.doc_lens[sel2], cfg.th_r)
    score = ops.pqscore_batched(*ps_args)
    err["pqscore"] = _exact((score,), (kps.pqscore_batched_ref(*ps_args),))
    if doc_pass is not None:
        score = torch.where(doc_pass[sel2], score, -torch.inf)
    top, local = topk(score, cfg.k)
    return dict(bits=bits, bf_args=bf_args, f=f, sel1=sel1,
                ci_args=ci_args, sbar=sbar, sel2=sel2, ps_args=ps_args,
                score=score, err=err, scores=top,
                ids=torch.gather(sel2, 1, local).to(torch.int32))


def token_hist(index):
    """Valid tokens per centroid over the corpus: (n_c,) int64, counted a
    block of docs at a time."""
    import torch
    n_docs, cap = index.codes.shape
    n_c = index.centroids.shape[0]
    hist = torch.zeros(n_c, dtype=torch.int64, device=index.codes.device)
    tok = torch.arange(cap, device=index.codes.device)
    step = 1 << 20
    for s in range(0, n_docs, step):
        valid = tok < index.doc_lens[s:s + step, None]
        hist += torch.bincount(
            index.codes[s:s + step].clamp(0, n_c - 1)[valid].long(),
            minlength=n_c)
    return hist


def lit_shares(bits, hist) -> dict:
    """How much of the word table bits (B, n_c) bitfilter's score pass
    gathers: the share of rows with a bit set, and rho, the share of the
    corpus' valid tokens (hist: per centroid) whose row is lit."""
    lit = (bits != 0).any(0)
    lit_tokens = int(hist[lit].sum())
    return {"lit_row_share": float(lit.float().mean()),
            "rho": lit_tokens / int(hist.sum()), "lit_tokens": lit_tokens}


def funnel(index, h, cfg) -> dict:
    """What the batch's phases did: candidates, the F distribution, ties at
    the n_filter cut, and the phase-3/4 spread."""
    import torch
    from repro_torch.core import bitvector
    from repro_torch.kernels import prefilter as kpf
    bits = bitvector.build_bitvectors(h["cs"], cfg.th)
    f = kpf.filter_scores_ref(bits, index.codes, index.doc_lens, h["bitmap"])
    cand = h["bitmap"].sum(1)
    # candidate queries per doc: how much of a batch shares one doc's codes
    cand_q = h["bitmap"].sum(0)
    cand_q = cand_q[cand_q > 0]
    hist = torch.bincount(f[f >= 0].long(), minlength=33)
    f_cut = h["pf"][0][:, -1:]
    tied = ((f == f_cut) & h["bitmap"]).sum(1)
    kept = (h["pf"][0] == f_cut).sum(1)
    return {"candidates_per_query": {"mean": float(cand.float().mean()),
                                     "min": int(cand.min()),
                                     "max": int(cand.max())},
            "docs_some_query_candidate": int(cand_q.numel()),
            "candidate_queries_per_candidate_doc": {
                "mean": float(cand_q.float().mean()),
                "histogram": torch.bincount(
                    cand_q, minlength=h["bitmap"].shape[0] + 1).tolist()},
            "F_histogram_over_candidates": hist.tolist(),
            "F_at_cut": h["pf"][0][:, -1].tolist(),
            "docs_tied_at_cut_mean": float(tied.float().mean()),
            "tied_docs_kept_mean": float(kept.float().mean()),
            "sbar_top_mean": float(h["pq"][3][:, 0].mean()),
            "sbar_cut_mean": float(h["pq"][3][:, -1].mean()),
            "score_top_mean": float(h["pq"][0][:, 0].mean()),
            "score_kth_mean": float(h["pq"][0][:, -1].mean())}


def term_filter_shares(h, cfg) -> dict:
    """What Eq. 6's term filter leaves to score over a held batch's phase-3
    winners (:func:`hold_phases`' ``h``), per query:
    ``interaction.scored_term_fraction`` (the share of (token, term) pairs
    whose centroid score beats th_r) and the share of (winner, term) pairs
    that keep some token (n_keep > 0, where Eq. 6 does not fall back to
    Eq. 5). None without th_r."""
    import torch
    from repro_torch.core import interaction
    from repro_torch.core.precision import greater
    if cfg.th_r is None:
        return None
    cs_t, _, codes, _, lens = h["operands"]
    sel2 = h["pq"][2].long()
    tok = torch.arange(codes.shape[2], device=codes.device)
    scored, kept = [], []
    for b in range(codes.shape[0]):
        rows = sel2[b][sel2[b] >= 0]
        c, valid = codes[b, rows], tok < lens[b, rows, None]
        scored.append(float(interaction.scored_term_fraction(
            cs_t[b], c, valid, cfg.th_r)))
        keep = greater(interaction.gather_centroid_scores(cs_t[b], c),
                       cfg.th_r) & valid[..., None]
        kept.append(float(keep.any(1).float().mean()))
    return {"scored_term_fraction_mean": sum(scored) / len(scored),
            "scored_term_fraction_min": min(scored),
            "scored_term_fraction_max": max(scored),
            "doc_term_pairs_kept_mean": sum(kept) / len(kept),
            "doc_term_pairs_kept_min": min(kept),
            "doc_term_pairs_kept_max": max(kept)}


def full_phase(dev) -> dict:
    """Phase 4: the planted index at full width, the main path at B = 32
    and B = 1 with its launch counts, the held phases, funnel and
    quality."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, meta = synthetic.make_packed_index(0, min_len=MIN_LEN, device=dev,
                                              **WIDTHS)
    queries, gt = synthetic.make_queries(index, 1, N_QUERIES, ENGINE["n_q"])
    torch.cuda.synchronize()
    fb = _field_bytes(index)
    emit("index", seconds=time.perf_counter() - t0, **WIDTHS,
         min_len=MIN_LEN, n_tokens=meta.n_raw_tokens,
         n_dropped=meta.n_dropped, field_bytes=fb,
         total_gb=sum(fb.values()) / 1e9,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)

    cfg = teng.EngineConfig(**ENGINE, use_kernels=True)
    ucfg = dataclasses.replace(cfg, fused_prefilter=False,
                               fused_late_interaction=False)
    launches, results, quality, digests = serve_lanes(
        index, {"fused": cfg, "unfused": ucfg}, queries, gt)
    held, held_u, lanes_equal = hold_lanes(
        index, cfg, ucfg, queries, results)
    fun = funnel(index, held["b32"], cfg)
    fun["term_filter"] = {b: term_filter_shares(held[b], cfg)
                          for b in ("b32", "b1")}
    hist = token_hist(index)
    fun["lit_rows"] = {b: lit_shares(held_u[b]["bits"], hist)
                       for b in ("b32", "b1")}
    emit("full", launches=launches, phases_exact=True,
         unfused_equals_fused=lanes_equal, funnel=fun, quality=quality,
         result_sha256=digests,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    for lane, qual in quality.items():
        if qual["success_at_100"] < SUCCESS_FLOOR:
            raise AssertionError(f"{lane} lane: planted Success@100 "
                                 f"{qual['success_at_100']} < {SUCCESS_FLOOR}")
    return dict(index=index, meta=meta, cfg=cfg, ucfg=ucfg, queries=queries,
                gt=gt, held=held, held_u=held_u, launches=launches,
                token_hist=hist)


def serve_lanes(index, cfgs: dict, queries, gt) -> tuple:
    """The main path of each lane of ``cfgs`` on ``index``: retrieve over
    N_QUERIES queries at B = 32, then N_SINGLE at B = 1, the launch counts
    set to 0 just before and read just after each (every kernel of the lane
    launched once a call, none of the other lane's); results well formed.
    -> (launches, first results, quality against ``gt``, digests) by
    lane."""
    import numpy as np
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    n_docs = index.codes.shape[0]
    batches = [queries[s:s + 32] for s in range(0, N_QUERIES, 32)]
    gt_np = gt.cpu().numpy()
    launches, results, quality, digests = {}, {}, {}, {}
    for lane, c in cfgs.items():
        ops.reset_launches()
        res = [teng.retrieve(index, q, c) for q in batches]
        torch.cuda.synchronize()
        launches[lane] = {"b32": ops.launch_counts()}
        ops.reset_launches()
        res1 = [teng.retrieve(index, queries[i:i + 1], c)
                for i in range(N_SINGLE)]
        torch.cuda.synchronize()
        launches[lane]["b1"] = ops.launch_counts()
        for name, kern in KERNELS.items():
            want = ((len(batches), N_SINGLE) if _on_lane(kern, lane)
                    else (0, 0))
            got = (launches[lane]["b32"][name], launches[lane]["b1"][name])
            if got != want:
                raise AssertionError(
                    f"{lane} lane: {name} launched {got[0]}x at B=32 and "
                    f"{got[1]}x at B=1, expected {want[0]}x and {want[1]}x")
        ids = torch.cat([r.doc_ids for r in res])
        scores = torch.cat([r.scores for r in res])
        if ids.shape != (N_QUERIES, ENGINE["k"]) or not torch.isfinite(
                scores).all() or not (scores[:, :-1] >= scores[:, 1:]).all() \
                or not ((ids >= 0) & (ids < n_docs)).all():
            raise AssertionError(f"{lane} retrieve returned malformed results")
        ids_np = ids.cpu().numpy()
        ids1_np = torch.cat([r.doc_ids for r in res1]).cpu().numpy()
        quality[lane] = {
            "success_at_100": synthetic.success_at_k(ids_np, gt_np, 100),
            "mrr_at_10": synthetic.mrr_at_k(ids_np, gt_np, 10),
            "success_at_100_b1": synthetic.success_at_k(
                ids1_np, gt_np[:N_SINGLE], 100),
            "mrr_at_10_b1": synthetic.mrr_at_k(ids1_np, gt_np[:N_SINGLE], 10),
            "b1_rows_equal_b32": int(sum(
                np.array_equal(ids1_np[i], ids_np[i])
                for i in range(N_SINGLE))),
        }
        results[lane] = {"b32": res[0], "b1": res1[0]}
        digests[lane] = {"b32": result_digest(res), "b1": result_digest(res1)}
    return launches, results, quality, digests


def hold_lanes(index, cfg, ucfg, queries, results) -> tuple:
    """The first B = 32 batch and the first B = 1 query held step by step
    on both lanes (:func:`hold_phases`, :func:`hold_unfused`), each
    composed to retrieve's result (``results`` of :func:`serve_lanes`), and
    unfused == fused on the same CS and LUT. -> (held, held_u,
    lanes_equal) by batch."""
    import torch
    from repro_torch.core import engine as teng
    held, held_u, lanes_equal = {}, {}, {}
    for name, q in (("b32", queries[:32]), ("b1", queries[:1])):
        h = hold_phases(index, q, cfg)
        u = hold_unfused(index, q, ucfg, h)
        for lane, got in (("fused", (h["ids"], h["pq"][0])),
                          ("unfused", (u["ids"], u["scores"]))):
            ref = results[lane][name]
            if not (torch.equal(got[0], ref.doc_ids) and torch.equal(
                    got[1].view(torch.int32), ref.scores.view(torch.int32))):
                raise AssertionError(f"{lane} {name}: the held phases do not "
                                     "compose to retrieve's result")
        # the reference's fused == unfused contract on the same CS and LUT
        a = teng._retrieve_batch(index, q, cfg, cs=h["cs"], lut=h["lut"])
        b = teng._retrieve_batch(index, q, ucfg, cs=h["cs"], lut=h["lut"])
        if not (torch.equal(a.doc_ids, b.doc_ids) and torch.equal(
                a.scores.view(torch.int32), b.scores.view(torch.int32))):
            raise AssertionError(f"{name}: unfused != fused on the same CS "
                                 "and LUT")
        lanes_equal[name] = True
        held[name], held_u[name] = h, u
    return held, held_u, lanes_equal


def result_digest(results) -> str:
    """sha256 of the doc ids and float32 score bits of a list of
    RetrievalResults: equal digests, equal results."""
    import hashlib
    h = hashlib.sha256()
    for r in results:
        h.update(r.doc_ids.cpu().numpy().tobytes())
        h.update(r.scores.cpu().numpy().tobytes())
    return h.hexdigest()


# --- 5. filtered and compact retrieval ---------------------------------------

# The predicate plane: bit i of a doc's word is predicate FILTER_PREDICATES[i]
# and holds with the rate beside it. 0.01 % leaves a few dozen of a query's
# ~137K candidates passing, fewer than k.
FILTER_PREDICATES = {"p50": 0.5, "p10": 0.1, "p1": 0.01, "p001": 0.0001}
CAND_CAP = 4096
FILTER_CONFIGS = {
    # name: (predicate of the filter or None, candidate mode)
    "filter1pct": ("p1", "score_all"),
    "filter001pct": ("p001", "score_all"),
    "compact": (None, "compact"),
    "compact_filter1pct": ("p1", "compact"),
}
# The kernel forms these configs give, timed on a config's own operands:
# kernel -> form -> (config, lane).
FORMS = {"prefilter": {"plan": ("filter1pct", "fused"),
                       "per_query": ("compact", "fused")},
         "pqinter": {"doc_pass": ("filter1pct", "fused")},
         "bitfilter": {"per_query": ("compact", "unfused")}}


def _lanes_agree(a, z, what: str, finite_only: bool) -> int:
    """Raise unless the fused result ``a`` and the unfused ``z`` agree in
    ids and score bits (with ``finite_only``, on the entries finite in both,
    which must sit in the same places: the lanes' fillers differ, as the
    reference's do); -> the finite entries."""
    import torch
    fin = torch.isfinite(a.scores)
    if finite_only:
        same = (torch.equal(fin, torch.isfinite(z.scores))
                and torch.equal(a.doc_ids[fin], z.doc_ids[fin])
                and torch.equal(a.scores[fin].view(torch.int32),
                                z.scores[fin].view(torch.int32)))
    else:
        same = (torch.equal(a.doc_ids, z.doc_ids) and torch.equal(
            a.scores.view(torch.int32), z.scores.view(torch.int32)))
    if not same:
        raise AssertionError(f"{what}: unfused != fused" + (
            " on the finite entries" if finite_only else ""))
    return int(fin.sum())


def check_filtered(ids, scores, passing) -> int:
    """Results (N, k) well formed: scores descending, no NaN, ids in the
    corpus, every finite-scored id passing the filter (``passing`` (n_docs,)
    bool, None when unfiltered). -> the count of -inf fillers."""
    import torch
    finite = torch.isfinite(scores)
    ordered = (scores[:, :-1] >= scores[:, 1:]).all()
    if torch.isnan(scores).any() or not ordered \
            or not ((ids >= 0) & (ids < WIDTHS["n_docs"])).all() \
            or not (finite | torch.isneginf(scores)).all():
        raise AssertionError("filtered retrieve returned malformed results")
    if passing is not None and not passing[ids[finite].long()].all():
        raise AssertionError("a finite-scored result fails the filter")
    if passing is None and not finite.all():
        raise AssertionError("an unfiltered result scored -inf")
    return int((~finite).sum())


def filter_phase(full: dict) -> dict:
    """Phase 5: the planted index with a predicate plane made on the card;
    per config of FILTER_CONFIGS and lane, retrieve at B = 32 and B = 1 with
    the launch counts read around those calls, the results checked against
    the filter, and one batch of each size held step by step (each kernel
    against its plain version) and composed to retrieve's result; unfused ==
    fused on the finite entries with the same CS and LUT."""
    import torch
    from repro_torch.core import bitvector
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    index = full["index"]
    t0 = time.perf_counter()
    index = index._replace(pred_words=predicate_words(
        index.codes.shape[0], dict(enumerate(FILTER_PREDICATES.values())),
        1, index.device))
    names = tuple(FILTER_PREDICATES)
    plans = {p: bitvector.compile_filter(bitvector.Pred(p), names)
             for p in names}
    passing = {p: bitvector.apply_filter_plan(plan, index.pred_words)
               for p, plan in plans.items()}
    torch.cuda.synchronize()
    emit("filter_plane", seconds=time.perf_counter() - t0,
         pass_share={p: float(x.float().mean()) for p, x in passing.items()},
         plane_bytes=index.pred_words.numel() * 4)
    queries = full["queries"]
    batches = [queries[s:s + 32] for s in range(0, N_QUERIES, 32)]
    out = {}
    for name, (pred, mode) in FILTER_CONFIGS.items():
        over = dict(candidate_mode=mode, cand_cap=CAND_CAP,
                    doc_filter=None if pred is None else plans[pred])
        cfgs = {"fused": dataclasses.replace(full["cfg"], **over),
                "unfused": dataclasses.replace(full["ucfg"], **over)}
        ok = None if pred is None else passing[pred]
        launches, results, fillers = {}, {}, {}
        for lane, c in cfgs.items():
            ops.reset_launches()
            res = [teng.retrieve(index, q, c) for q in batches]
            torch.cuda.synchronize()
            launches[lane] = {"b32": ops.launch_counts()}
            ops.reset_launches()
            res1 = [teng.retrieve(index, queries[i:i + 1], c)
                    for i in range(N_SINGLE)]
            torch.cuda.synchronize()
            launches[lane]["b1"] = ops.launch_counts()
            for kname, kern in KERNELS.items():
                want = ((len(batches), N_SINGLE) if _on_lane(kern, lane)
                        else (0, 0))
                got = tuple(launches[lane][b][kname] for b in ("b32", "b1"))
                if got != want:
                    raise AssertionError(
                        f"{name} {lane}: {kname} launched {got}, expected "
                        f"{want}")
            fillers[lane] = {
                "b32": check_filtered(torch.cat([r.doc_ids for r in res]),
                                      torch.cat([r.scores for r in res]), ok),
                "b1": check_filtered(torch.cat([r.doc_ids for r in res1]),
                                     torch.cat([r.scores for r in res1]), ok)}
            results[lane] = {"b32": res[0], "b1": res1[0]}
        if pred == "p001" and not fillers["fused"]["b32"]:
            raise AssertionError("the 0.01 % filter left k passing docs")
        held, passing_cands = {}, {}
        for b, q in (("b32", batches[0]), ("b1", queries[:1])):
            h = hold_phases(index, q, cfgs["fused"])
            u = hold_unfused(index, q, cfgs["unfused"], h)
            for lane, got in (("fused", (h["ids"], h["pq"][0])),
                              ("unfused", (u["ids"], u["scores"]))):
                ref = results[lane][b]
                if not (torch.equal(got[0], ref.doc_ids) and torch.equal(
                        got[1].view(torch.int32),
                        ref.scores.view(torch.int32))):
                    raise AssertionError(f"{name} {lane} {b}: the held "
                                         "phases do not compose to retrieve")
            a = teng._retrieve_batch(index, q, cfgs["fused"], cs=h["cs"],
                                     lut=h["lut"])
            z = teng._retrieve_batch(index, q, cfgs["unfused"], cs=h["cs"],
                                     lut=h["lut"])
            _lanes_agree(a, z, f"{name} {b}", finite_only=True)
            cand = h["bitmap"] if ok is None else h["bitmap"] & ok
            passing_cands[b] = cand.sum(1).tolist()[:8]
            held[b] = {"h": h, "u": u, "q": q}
        out[name] = dict(cfgs=cfgs, held=held, launches=launches)
        emit(f"filter_{name}", predicate=pred, candidate_mode=mode,
             cand_cap=CAND_CAP, launches=launches, phases_exact=True,
             unfused_equals_fused_where_finite=True, fillers=fillers,
             passing_candidates_first_queries=passing_cands,
             max_abs_err={b: {**v["h"]["err"], **v["u"]["err"]}
                          for b, v in held.items()})
    return dict(index=index, configs=out)


# --- 5b. timeline: generations encoded on the card -------------------------

GEN_DOCS = 2048      # docs of each encoded generation
GEN2_OPEN = 1536     # generation 2 opens with these; add_passages the rest
TL_QUERIES = 22      # planted on generation 0; 21 each on generations 1, 2
ENCODE_HOLD = (128, 32)  # docs held against the CPU encode: generation 1's
#                          first, then the first that add_passages grew
#                          generation 2 by
ENCODE_REPS = 3      # warm encode calls timed after the first (cold) one
MERGE_BUDGETS = dict(n_filter=4096, n_docs=4096, cand_cap=4096)  # lossless
#                          over generations 1-2 (pqinter takes n_filter 4096)


def _codebooks_on_cpu(index):
    """An index's frozen codebooks on the CPU, its per-doc fields empty: all
    that encoding new passages against it reads."""
    book = ("centroids", "pq_codebooks", "plaid_cutoffs", "plaid_weights",
            "opq_rotation")
    return index._replace(**{f: getattr(index, f).cpu() if f in book
                             else getattr(index, f)[:0].cpu()
                             for f in index._fields})


def encode_hold(index, meta, g1, g2, a, la, b, lb) -> dict:
    """The served generations' encode on the card against the port's CPU
    path on the same docs: generation 1's first ENCODE_HOLD[0] docs
    (new_generation of docs ``a``) and the first ENCODE_HOLD[1] docs that
    add_passages grew generation 2 by (docs ``b`` from GEN2_OPEN), encoded
    on the CPU as one new generation grown by add_passages. At real tokens:
    codes equal except at near-ties, each measured in float64 and at most
    kmeans.NEAR_TIE_EPS apart; PQ codes likewise where the codes agree;
    PLAID codes equal where the codes agree; lengths and predicate words
    equal. Each served generation's IVF equals build_ivf of its own codes
    on the CPU, and generation 1's meta the CPU's list_cap, n_dropped and
    mean squared real residual from those codes. -> the counts."""
    import numpy as np
    import torch
    from repro_torch.core import index as tindex
    from repro_torch.core import store as tstore
    n, m = ENCODE_HOLD
    grown = slice(GEN2_OPEN, GEN2_OPEN + m)
    (c1, m1), (c2, _) = g1, g2
    cpu_base = _codebooks_on_cpu(index)
    t0 = time.perf_counter()
    host = tstore.new_generation(cpu_base, meta, a[:n], la[:n], device="cpu")
    hi, _ = tstore.add_passages(*host, b[grown], lb[grown], device="cpu")
    cpu_seconds = time.perf_counter() - t0
    card = {f: torch.cat([getattr(c1, f)[:n].cpu(), getattr(c2, f)[grown]
                          .cpu()]) for f in ENCODE_FIELDS}
    counts = compare_encodes(meta, cpu_base, card, hi, np.concatenate(
        [a[:n], b[grown]]), np.concatenate([la[:n], lb[grown]]))
    built = {}
    for g, gi in ((1, c1), (2, c2)):
        ivf, ivf_lens, *built[g] = tindex.build_ivf(
            gi.codes.cpu(), meta.n_centroids, None, origin="new_generation")
        if not (torch.equal(gi.ivf.cpu(), ivf)
                and torch.equal(gi.ivf_lens.cpu(), ivf_lens)):
            raise AssertionError(f"generation {g}: the IVF is not its "
                                 "codes' on the CPU")
    a_real = (np.arange(meta.cap)[None] < la[:, None]).reshape(-1)
    r1 = (tindex.normalized_tokens(a)[a_real] - cpu_base.centroids.numpy()[
        c1.codes.cpu().numpy().reshape(-1)[a_real]])
    mse = float(np.sum(r1 * r1)) / max(int(a_real.sum()), 1)
    if [m1.list_cap, m1.n_dropped, m1.grown_quant_mse] != built[1] + [mse]:
        raise AssertionError(f"generation 1: meta (list_cap, n_dropped, "
                             f"grown_quant_mse) {m1} is not its codes' on "
                             f"the CPU ({built[1]}, {mse})")
    return {"docs": n + m, **counts, "ivf_equal": True,
            "generation_1_meta_equal": True, "cpu_seconds": cpu_seconds}


ENCODE_FIELDS = ("codes", "res_codes", "plaid_res", "doc_lens", "pred_words")


def compare_encodes(meta, cpu_base, card, hi, embs, lens) -> dict:
    """Docs ``embs`` (numpy, with their ``lens``) as encoded on the card
    (``card``: ENCODE_FIELDS on the CPU) against their CPU encode ``hi``
    against the same codebooks ``cpu_base``: lengths and predicate words
    equal; at real tokens, codes equal except at near-ties, each measured in
    float64 and at most kmeans.NEAR_TIE_EPS apart; PQ codes likewise where
    the codes agree; PLAID codes equal where the codes agree; padding codes
    equal. -> the counts."""
    import numpy as np
    import torch
    from repro_torch.core import index as tindex
    from repro_torch.core import kmeans
    for f in ("doc_lens", "pred_words"):
        if not torch.equal(card[f], getattr(hi, f)):
            raise AssertionError(f"card and CPU encodes: {f} differs")
    x = torch.from_numpy(tindex.normalized_tokens(embs))
    real = (np.arange(meta.cap)[None] < lens[:, None]).reshape(-1)
    on_card, on_cpu = card["codes"].reshape(-1), hi.codes.reshape(-1)
    diff = (on_card != on_cpu).numpy()
    if (diff & ~real).any():
        raise AssertionError("card and CPU encodes: padding codes differ")
    gap = kmeans.choice_gap(x[diff], cpu_base.centroids, on_cpu[diff],
                            on_card[diff])
    agree = real & ~diff
    rc = card["res_codes"].numpy().reshape(-1, meta.m)
    hc = hi.res_codes.numpy().reshape(-1, meta.m)
    pq_rows, pq_subs = np.nonzero((rc != hc) & agree[:, None])
    dsub = meta.d // meta.m
    residual = x - cpu_base.centroids[on_cpu.clamp(max=meta.n_centroids - 1)
                                      .long()]    # read at real tokens only
    pq_gap = torch.cat([kmeans.choice_gap(
        residual[r:r + 1, s * dsub:(s + 1) * dsub],
        cpu_base.pq_codebooks[s], torch.tensor([int(hc[r, s])]),
        torch.tensor([int(rc[r, s])])) for r, s in zip(pq_rows, pq_subs)]
        or [torch.zeros(0, dtype=torch.float64)])
    worst = max([0.0] + gap.tolist() + pq_gap.tolist())
    if worst > kmeans.NEAR_TIE_EPS:
        raise AssertionError(f"card and CPU encodes differ beyond a near "
                             f"tie: gap {worst} > {kmeans.NEAR_TIE_EPS}")
    if not np.array_equal(
            card["plaid_res"].numpy().reshape(len(real), -1)[agree],
            hi.plaid_res.numpy().reshape(len(real), -1)[agree]):
        raise AssertionError("PLAID codes differ where the card's and the "
                             "CPU's codes agree")
    return {"real_tokens": int(real.sum()),
            "assign_near_ties": int(diff.sum()),
            "pq_near_ties": len(pq_rows), "max_gap": worst,
            "near_tie_eps": kmeans.NEAR_TIE_EPS}


def _interleaved(parts):
    """Rows of several (queries, gt, generation) parts interleaved, one of
    each in turn, so that every batch and the first B = 1 queries hold
    targets of every generation."""
    import torch
    order = [(p, i) for i in range(max(len(q) for q, _, _ in parts))
             for p in range(len(parts)) if i < len(parts[p][0])]
    q = torch.stack([parts[p][0][i] for p, i in order])
    gt = torch.stack([parts[p][1][i] for p, i in order])
    gen = torch.tensor([parts[p][2] for p, _ in order])
    return q, gt, gen


def _same_result(a, b) -> bool:
    import torch
    return torch.equal(a.doc_ids, b.doc_ids) and torch.equal(
        a.scores.view(torch.int32), b.scores.view(torch.int32))


def timeline_phase(full: dict) -> dict:
    """Phase 5b: generation 0 is the full-width planted index as it is;
    generations 1 and 2 are raw passages made on the card and encoded
    against its frozen codebooks (new_generation; add_passages and
    with_newest for generation 2), held against the CPU encode; then
    retrieve_timeline on both lanes at B = 32 and B = 1 with the launch
    counts read around those calls, each generation's kernels held against
    their plain versions, unfused == fused per generation on the same CS and
    LUT, the held partials merged to retrieve_timeline's result, global ids
    in their generation's range, and the planted Success@100; then
    merge_generations over generations 1-2 (retrieval equal before and
    after under lossless budgets), a save/load round trip of generations
    1-2, the timeline's footprint, and the timeline's ms per generation
    count beside retrieve on generation 0."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.core import store as tstore
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    index, meta = full["index"], full["meta"]
    t0 = time.perf_counter()
    raw = {}
    for name, seed in (("a", 2), ("b", 3)):
        embs, lens = synthetic.make_raw_docs(index, seed, GEN_DOCS, MIN_LEN)
        raw[name] = (embs, lens, embs.cpu().numpy(), lens.cpu().numpy())
    make_s = time.perf_counter() - t0
    (_, _, a, la), (_, _, b, lb) = raw["a"], raw["b"]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    g1, s1 = timed(lambda: tstore.new_generation(index, meta, a, la))
    g2_open, s2 = timed(lambda: tstore.new_generation(
        index, meta, b[:GEN2_OPEN], lb[:GEN2_OPEN]))
    tl = tstore.ShardedTimeline.of((index, meta), g1).append(*g2_open)
    g2, s3 = timed(lambda: tstore.add_passages(*g2_open, b[GEN2_OPEN:],
                                               lb[GEN2_OPEN:]))
    tl = tl.with_newest(*g2)
    if tl.offsets != (0, meta.n_docs, meta.n_docs + GEN_DOCS) or \
            tl.metas[2].n_grown != GEN_DOCS or g2[0].plaid_res.shape[0] \
            != GEN_DOCS:
        raise AssertionError(f"timeline malformed: {tl.offsets}")
    encodes = {
        "new_generation_1": (lambda: tstore.new_generation(index, meta, a,
                                                           la), la, s1),
        "new_generation_2": (lambda: tstore.new_generation(
            index, meta, b[:GEN2_OPEN], lb[:GEN2_OPEN]), lb[:GEN2_OPEN], s2),
        "add_passages_2": (lambda: tstore.add_passages(
            *g2_open, b[GEN2_OPEN:], lb[GEN2_OPEN:]), lb[GEN2_OPEN:], s3)}
    warm = {k: statistics.median(timed(fn)[1] for _ in range(ENCODE_REPS))
            for k, (fn, _, _) in encodes.items()}
    hold = encode_hold(index, meta, g1, g2, a, la, b, lb)
    emit("timeline_encode", generations=len(tl), offsets=tl.offsets,
         docs=[m.n_docs for m in tl.metas], make_docs_seconds=make_s,
         tokens={k: int(v[1].sum()) for k, v in encodes.items()},
         cold_seconds={k: v[2] for k, v in encodes.items()},
         warm_seconds_median=warm, warm_calls=ENCODE_REPS,
         tokens_per_second={k: int(v[1].sum()) / warm[k]
                            for k, v in encodes.items()},
         tokens_per_second_cold={k: int(v[1].sum()) / v[2]
                                 for k, v in encodes.items()},
         drift=[m.drift for m in tl.metas[1:]],
         list_cap=[m.list_cap for m in tl.metas], card_vs_cpu=hold)

    n_q = ENGINE["n_q"]
    parts = [(full["queries"][:TL_QUERIES], full["gt"][:TL_QUERIES], 0)]
    for g, (name, seed) in enumerate((("a", 4), ("b", 5)), start=1):
        q, gt = synthetic.make_raw_queries(raw[name][0], raw[name][1], seed,
                                           TL_QUERIES - 1, n_q)
        parts.append((q, gt + tl.offsets[g], g))
    queries, gt, gen_of = _interleaved(parts)
    batches = [queries[s:s + 32] for s in range(0, len(queries), 32)]
    cfgs = {"fused": full["cfg"], "unfused": full["ucfg"]}
    launches, quality, results = {}, {}, {}
    gt_np, gen_np = gt.cpu().numpy(), gen_of.numpy()
    for lane, c in cfgs.items():
        ops.reset_launches()
        res = [teng.retrieve_timeline(tl, q, c) for q in batches]
        torch.cuda.synchronize()
        launches[lane] = {"b32": ops.launch_counts()}
        ops.reset_launches()
        res1 = [teng.retrieve_timeline(tl, queries[i:i + 1], c)
                for i in range(N_SINGLE)]
        torch.cuda.synchronize()
        launches[lane]["b1"] = ops.launch_counts()
        for kname, kern in KERNELS.items():
            want = ((len(batches) * len(tl), N_SINGLE * len(tl))
                    if _on_lane(kern, lane) else (0, 0))
            got = tuple(launches[lane][x][kname] for x in ("b32", "b1"))
            if got != want:
                raise AssertionError(f"timeline {lane}: {kname} launched "
                                     f"{got}, expected {want}")
        ids = torch.cat([r.doc_ids for r in res])
        scores = torch.cat([r.scores for r in res])
        if not torch.isfinite(scores).all() or not (
                scores[:, :-1] >= scores[:, 1:]).all() or not (
                (ids >= 0) & (ids < tl.n_docs)).all():
            raise AssertionError(f"timeline {lane}: malformed results")
        ids_np = ids.cpu().numpy()
        quality[lane] = {
            "success_at_100": synthetic.success_at_k(ids_np, gt_np, 100),
            "mrr_at_10": synthetic.mrr_at_k(ids_np, gt_np, 10),
            "success_at_100_by_generation": [
                synthetic.success_at_k(ids_np[gen_np == g], gt_np[gen_np == g],
                                       100) for g in range(len(tl))],
            "success_at_100_b1": synthetic.success_at_k(
                torch.cat([r.doc_ids for r in res1]).cpu().numpy(),
                gt_np[:N_SINGLE], 100)}
        results[lane] = {"b32": res[0], "b1": res1[0]}

    errs, hits = {}, {}
    for bname, q in (("b32", batches[0]), ("b1", queries[:1])):
        held = {"fused": [], "unfused": []}
        for g, (gi, gm, off) in enumerate(tl):
            gc = teng.adapt_config_to_corpus(cfgs["fused"], gm.n_docs, gm.cap)
            gu = teng.adapt_config_to_corpus(cfgs["unfused"], gm.n_docs,
                                             gm.cap)
            h = hold_phases(gi, q, gc)
            u = hold_unfused(gi, q, gu, h)
            errs[f"{bname}_gen{g}"] = {**h["err"], **u["err"]}
            f_res = teng._retrieve_batch(gi, q, gc, cs=h["cs"], lut=h["lut"])
            u_res = teng._retrieve_batch(gi, q, gu, cs=h["cs"], lut=h["lut"])
            if not _same_result(f_res, u_res):
                raise AssertionError(f"generation {g} {bname}: unfused != "
                                     "fused on the same CS and LUT")
            for lane, r, got in (("fused", f_res, (h["ids"], h["pq"][0])),
                                 ("unfused", u_res,
                                  (u["ids"], u["scores"]))):
                if not _same_result(r, teng.RetrievalResult(got[1], got[0])):
                    raise AssertionError(f"generation {g} {bname} {lane}: "
                                         "the held phases do not compose")
                if not ((r.doc_ids >= 0) & (r.doc_ids < gm.n_docs)).all():
                    raise AssertionError(f"generation {g}: ids outside it")
                held[lane].append(r)
        for lane in cfgs:
            merged = teng.merge_generation_topk(held[lane], tl.offsets,
                                                ENGINE["k"])
            if not _same_result(merged, results[lane][bname]):
                raise AssertionError(f"timeline {lane} {bname}: the held "
                                     "generations do not merge to "
                                     "retrieve_timeline's result")
            ids = merged.doc_ids.cpu().numpy()
            hits[f"{lane}_{bname}"] = [
                int(((ids >= o) & (ids < o + m.n_docs)).sum())
                for o, m in zip(tl.offsets, tl.metas)]
    emit("timeline", generations=len(tl), n_docs=tl.n_docs,
         launches=launches, phases_exact=True,
         unfused_equals_fused_per_generation=True,
         held_partials_merge_to_result=True, quality=quality,
         results_per_generation_first_batch=hits, max_abs_err=errs)
    for lane, qual in quality.items():
        low = min(qual["success_at_100"], *qual[
            "success_at_100_by_generation"])
        if low < SUCCESS_FLOOR:
            raise AssertionError(f"timeline {lane}: planted Success@100 "
                                 f"{low} < {SUCCESS_FLOOR}")

    merged, merge_s = timed(lambda: tstore.merge_generations(tl, 1, 3))
    if merged.generations[0] is not tl.generations[0] or \
            merged.offsets != tl.offsets[:2] or merged.n_docs != tl.n_docs:
        raise AssertionError("merge_generations moved generation 0")
    pair = tstore.ShardedTimeline(tl.generations[1:], tl.metas[1:])
    one = tstore.ShardedTimeline(merged.generations[1:], merged.metas[1:])
    equal = {}
    for lane, c in cfgs.items():
        lc = dataclasses.replace(c, **MERGE_BUDGETS)
        for bname, q in (("b32", batches[0]), ("b1", queries[:1])):
            x = teng.retrieve_timeline(pair, q, lc)
            y = teng.retrieve_timeline(one, q, lc)
            if not _same_result(x, y):
                raise AssertionError(f"merge {lane} {bname}: retrieval "
                                     "differs after merge_generations")
            equal[f"{lane}_{bname}"] = True
    emit("timeline_merge", range=[1, 3], ms=merge_s * 1e3,
         merged_docs=merged.metas[1].n_docs,
         list_cap=merged.metas[1].list_cap, budgets=MERGE_BUDGETS,
         retrieval_equal=equal)

    with tempfile.TemporaryDirectory() as tmp:
        _, save_s = timed(lambda: tstore.save_timeline(tmp, pair))
        back, load_s = timed(lambda: tstore.load_timeline(tmp))
        if back.fingerprints != pair.fingerprints or not all(
                torch.equal(getattr(x, f), getattr(y, f))
                for x, y in zip(back.generations, pair.generations)
                for f in x._fields) or back.metas != pair.metas:
            raise AssertionError("save_timeline/load_timeline round trip "
                                 "changed generations 1-2")
    fp = tstore.timeline_footprint(tl)
    emit("timeline_store", round_trip_generations=[1, 2],
         fingerprints=list(pair.fingerprints), save_seconds=save_s,
         load_seconds=load_s,
         footprint={k: v for k, v in fp.items() if k != "generations"},
         footprint_total_bytes_per_generation=[
             g["total_bytes"] for g in fp["generations"]])

    smi = RECORD["device"]["nvidia_smi"]
    tls = {1: tstore.ShardedTimeline.of((index, meta)),
           2: tstore.ShardedTimeline.of((index, meta), g1), 3: tl}
    flush = torch.empty(64 << 20, dtype=torch.int32, device=index.device)
    ms = {}
    for lane, c in cfgs.items():
        for bname, q in (("b32", batches[0]), ("b1", queries[:1])):
            row = {"retrieve_generation_0": time_ms(
                lambda: teng.retrieve(index, q, c), flush=flush)}
            for n, t in tls.items():
                row[f"retrieve_timeline_{n}"] = time_ms(
                    lambda t=t: teng.retrieve_timeline(t, q, c), flush=flush)
            ms[f"{lane}_{bname}"] = row
    emit("timing_timeline", nvidia_smi=smi, ms=ms)
    return dict(timeline=tl, merged=merged, queries=queries, gt=gt)


# --- 5c. index_build: the trained build on the card -------------------------

BUILD_DOCS = 32_768   # raw passages built over: a cut of MS MARCO's 8,841,823
BUILD_SEED = 7        # the passages' seed and build_index's
# The reference's defaults but 4 k-means iterations of its 8 (each ~8.5 s
# at these widths on an H100; the depth cut keeps the script near 650 s
# beside the recsys phase; every iteration is still timed).
BUILD = dict(n_centroids=WIDTHS["n_centroids"], m=WIDTHS["m"],
             nbits=WIDTHS["nbits"], plaid_b=2, list_cap=WIDTHS["list_cap"],
             kmeans_iters=4, pq_train_size=65_536)
BUILD_HOLD = 128      # docs encoded again on the CPU against the trained books
MIN_TRAIN_TOKENS = 1 << 18   # real tokens the k-means must see at least


class StageClock:
    """Times the stages of build_index: while it is entered, the functions
    build_index (``core/index.py``) and the k-means (``core/kmeans.py``)
    call by module attribute are wrapped to synchronize, time and
    synchronize; each call lands in ``calls`` as (stage, function,
    seconds), the stage being the build_index step it ran under."""

    STAGES = ("kmeans_spherical", "quantize_tokens", "train_pq", "encode_pq",
              "train_residual_codec", "encode_residual", "build_ivf")
    STEPS = ("assign", "_update")

    def __init__(self):
        """No call timed yet; nothing wrapped until entered."""
        self.calls: list = []
        self._stage = None
        self._saved: list = []

    def __enter__(self):
        """Wrap the stage and step functions."""
        from repro_torch.core import index, kmeans
        for mod, names in ((index, self.STAGES), (kmeans, self.STEPS)):
            for name in names:
                fn = getattr(mod, name)
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._timed(name, fn, mod is index))
        return self

    def __exit__(self, *exc):
        """Put the functions back."""
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False

    def _timed(self, name, fn, stage: bool):
        import torch

        def timed(*args, **kwargs):
            if stage:
                self._stage = name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((self._stage, name, time.perf_counter() - t0))
            return out
        return timed

    def seconds(self, stage: str, fn=None) -> list:
        """Seconds of each call of ``fn`` (the stage itself by default)
        made under ``stage``."""
        return [s for st, f, s in self.calls
                if st == stage and f == (fn or stage)]


def update_twice(index, embs, lens) -> bool:
    """k-means' update step run twice on the card on the build's real
    tokens and their assignment (the codes): bit-equal, or raise."""
    import numpy as np
    import torch
    from repro_torch.core import index as tindex
    from repro_torch.core import kmeans
    real = (np.arange(embs.shape[1])[None] < lens[:, None]).reshape(-1)
    x = torch.from_numpy(tindex.normalized_tokens(embs)[real]).to(
        index.device)
    a = index.codes.reshape(-1)[torch.from_numpy(real).to(index.device)]
    k = index.centroids.shape[0]
    one, two = (kmeans._update(x, a, k, index.centroids, kmeans.generator(0))
                for _ in range(2))
    if not torch.equal(one.view(torch.int32), two.view(torch.int32)):
        raise AssertionError("k-means _update gave other bits on a second "
                             "run over the same assignment")
    return True


def index_build_phase(full: dict) -> dict:
    """Phase 5c: build_index on the card at the emvb-msmarco widths over
    BUILD_DOCS raw passages drawn on the planted index's centroid table
    (stage times under :class:`StageClock`, k-means iterations against the
    float32 floor of their assignment), then the main path on the trained
    index: retrieve on both lanes at B = 32 and B = 1 with planted queries
    and launch counts, each kernel held against its plain version, planted
    Success@100 and MRR@10, rho beside the planted index's; the first
    BUILD_HOLD docs encoded on the CPU against the trained codebooks equal
    but for near-ties; k-means' update twice, bit-equal."""
    import numpy as np
    import torch
    from repro_torch.core import index as tindex
    from repro_torch.core import store as tstore
    from repro_torch.data import synthetic
    t0 = time.perf_counter()
    embs_t, lens_t = synthetic.make_raw_docs(full["index"], BUILD_SEED,
                                             BUILD_DOCS, MIN_LEN)
    embs, lens = embs_t.cpu().numpy(), lens_t.cpu().numpy()
    make_s = time.perf_counter() - t0
    n_tok = int(lens.sum())
    if n_tok < max(MIN_TRAIN_TOKENS, BUILD["n_centroids"]):
        raise AssertionError(f"{n_tok} real tokens: too few to train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with StageClock() as clock:
        t0 = time.perf_counter()
        index, meta = tindex.build_index(BUILD_SEED, embs, lens,
                                         device=full["index"].device, **BUILD)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    iters = BUILD["kmeans_iters"]
    assign_s = clock.seconds("kmeans_spherical", "assign")
    update_s = clock.seconds("kmeans_spherical", "_update")
    floor_ms = 2 * n_tok * BUILD["n_centroids"] * meta.d / F32_OPS_PER_S * 1e3
    fb = _field_bytes(index)
    emit("index_build", docs=BUILD_DOCS, real_tokens=n_tok,
         padded_tokens=BUILD_DOCS * meta.cap, make_docs_seconds=make_s,
         build_seconds=build_s, training_tokens_per_second=n_tok / build_s,
         stage_seconds={st: sum(clock.seconds(st)) for st in
                        StageClock.STAGES},
         kmeans_iteration_ms=[(a + u) * 1e3 for a, u in
                              zip(assign_s[:iters], update_s)],
         kmeans_assign_ms=[a * 1e3 for a in assign_s],
         kmeans_update_ms=[u * 1e3 for u in update_s],
         assign_floor_ms=floor_ms, pq_train_assign_ms=[
             a * 1e3 for a in clock.seconds("train_pq", "assign")],
         index_bytes=sum(fb.values()), field_bytes=fb,
         list_cap=meta.list_cap, n_dropped=meta.n_dropped,
         train_quant_mse=meta.train_quant_mse, build=BUILD,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)

    queries, gt = synthetic.make_raw_queries(embs_t, lens_t, BUILD_SEED + 1,
                                             N_QUERIES, ENGINE["n_q"])
    del embs_t, lens_t
    cfg, ucfg = full["cfg"], full["ucfg"]
    launches, results, quality, _ = serve_lanes(
        index, {"fused": cfg, "unfused": ucfg}, queries, gt)
    held, held_u, lanes_equal = hold_lanes(index, cfg, ucfg, queries,
                                           results)
    hist = token_hist(index)
    rho = {b: lit_shares(held_u[b]["bits"], hist) for b in ("b32", "b1")}
    planted = {b: lit_shares(full["held_u"][b]["bits"], full["token_hist"])
               for b in ("b32", "b1")}
    cpu_base = _codebooks_on_cpu(index)
    t0 = time.perf_counter()
    hi, _ = tstore.new_generation(cpu_base, meta, embs[:BUILD_HOLD],
                                  lens[:BUILD_HOLD], device="cpu")
    cpu_s = time.perf_counter() - t0
    card = {f: getattr(index, f)[:BUILD_HOLD].cpu() for f in ENCODE_FIELDS}
    encode = compare_encodes(meta, cpu_base, card, hi, embs[:BUILD_HOLD],
                             lens[:BUILD_HOLD])
    emit("index_build_serve", launches=launches, phases_exact=True,
         unfused_equals_fused=lanes_equal, quality=quality,
         lit_rows=rho, lit_rows_planted=planted,
         max_abs_err={b: {**held[b]["err"], **held_u[b]["err"]}
                      for b in ("b32", "b1")},
         card_vs_cpu_encode={"docs": BUILD_HOLD, **encode,
                             "cpu_seconds": cpu_s},
         update_twice_bit_equal=update_twice(index, embs, lens))
    for lane, qual in quality.items():
        if qual["success_at_100"] < SUCCESS_FLOOR:
            raise AssertionError(f"trained index, {lane} lane: Success@100 "
                                 f"{qual['success_at_100']} < {SUCCESS_FLOOR}")
    return {"launches": launches, "held": held, "held_u": held_u,
            "index": index, "queries": queries, "gt": gt}


# --- 5d. serving: RetrievalService over the full-width timeline -------------

SERVE_BATCH = 16      # max_batch of the service
SERVE_TERMS = (8, 32)  # a served query's term count, uniform in this range
SWAP_PENDING = 5      # tickets pending when a new generation is staged
SWAP_DOCS = 512       # docs of that generation
ADD_DOCS = 256        # docs add_passages then grows it by
DRIFT_DOCS = 4096     # docs of the drifted generation the runner re-epochs
DRIFT_NOISE = (0.45, 0.6, 0.8, 1.2)  # token noise tried until drift > 1.5


def _lint_exposition(text: str) -> list:
    """scripts/check_metrics_exposition.py's validator, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_metrics_exposition",
        os.path.join(ROOT, "scripts", "check_metrics_exposition.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_exposition(text)


def _tickets_equal(tickets, want) -> bool:
    """Each ticket's (scores, ids) equal row i of ``want``, score bits
    included."""
    import numpy as np
    ids, sc = want.doc_ids.cpu().numpy(), want.scores.cpu().numpy()
    return all(np.array_equal(t.result()[1], ids[i]) and np.array_equal(
        t.result()[0].view(np.uint32), sc[i].view(np.uint32))
        for i, t in enumerate(tickets))


def _padded(qs: list):
    """The service's padded batch of ``qs`` (numpy (t, d) queries):
    (queries, masks), each stacked."""
    import numpy as np
    from repro_torch.serving import pad_query
    q, m = zip(*(pad_query(x, ENGINE["n_q"]) for x in qs))
    return np.stack(q), np.stack(m)


def _submit_all(svc, qs: list) -> tuple:
    """Submit ``qs`` one at a time (a flush every SERVE_BATCH), flush the
    rest. -> (tickets, per-query ms from submit to its answer)."""
    import torch
    tickets, submitted, done = [], [], {}
    for q in qs:
        submitted.append(time.perf_counter())
        tickets.append(svc.submit(q))
        now = time.perf_counter()
        for i, t in enumerate(tickets):
            if t.done and i not in done:
                done[i] = now
    svc.flush()
    torch.cuda.synchronize()
    now = time.perf_counter()
    return tickets, [((done.get(i, now)) - s) * 1e3
                     for i, s in enumerate(submitted)]


def _ms_stats(ms: list) -> dict:
    return {"median_ms": statistics.median(ms),
            "p90_ms": sorted(ms)[-(-9 * len(ms) // 10) - 1], "n": len(ms)}


def serving_phase(full: dict, filt: dict, tlres: dict) -> dict:
    """Phase 5d: RetrievalService over the timeline phase's timeline (the
    planted base and its two generations) with the fused config: planted
    queries of SERVE_TERMS terms submitted one at a time, cold then warm,
    every ticket == retrieve_timeline on the same padded batch and warm ==
    cold, the launch counts read around that traffic; the invariance of a
    query's row to its batch (the B = 16 flush against retrieve_timeline at
    B = 1 and in a miss lane padded with its own row), counted; a filtered
    batch through query() on the timeline with a predicate plane; a hot
    swap staged behind pending tickets; add_passages; MaintenanceRunner's
    merge of generations 1-2 (results equal before and after under lossless
    budgets); a drifted generation re-epoched by the runner with fresh
    codebooks on the card and the epoched timeline served; the service's
    metrics and its exposition, linted."""
    import numpy as np
    import torch
    from repro_torch.core import bitvector
    from repro_torch.core import engine as teng
    from repro_torch.core import store as tstore
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.serving import (MaintenancePolicy, MaintenanceRunner,
                                     RetrievalService)
    tl, index, meta = tlres["timeline"], full["index"], full["meta"]
    cfg = full["cfg"]
    rng = np.random.default_rng(BUILD_SEED)
    qs = [q[:rng.integers(SERVE_TERMS[0], SERVE_TERMS[1] + 1)]
          for q in tlres["queries"].cpu().numpy()]
    batches = [qs[s:s + SERVE_BATCH] for s in range(0, len(qs), SERVE_BATCH)]

    svc = RetrievalService(tl, cfg, max_batch=SERVE_BATCH)
    fingerprints = svc._fingerprints(tl)
    ops.reset_launches()
    cold, cold_ms = _submit_all(svc, qs)
    warm, warm_ms = _submit_all(svc, qs)
    launches = ops.launch_counts()
    want_launches = len(batches) * (len(tl) + 1)   # cold: every generation
    for name, kern in KERNELS.items():
        want = want_launches if _on_lane(kern, "fused") else 0
        if launches[name] != want:
            raise AssertionError(f"serving: {name} launched "
                                 f"{launches[name]}x, expected {want}x")
    flush_rows = {}
    for b, part in enumerate(batches):
        q, m = _padded(part)
        want = teng.retrieve_timeline(tl, q, cfg, m)
        rows = slice(b * SERVE_BATCH, b * SERVE_BATCH + len(part))
        if not (_tickets_equal(cold[rows], want)
                and _tickets_equal(warm[rows], want)):
            raise AssertionError(f"serving batch {b}: a ticket differs from "
                                 "retrieve_timeline on its padded batch")
        flush_rows[b] = want
    traffic = svc.stats()

    # batch invariance: is a query's row the same in any batch on the card?
    differ = {"b1": {"rows": 0, "ids": 0, "score_bits": 0},
              "padded_miss_lane": {"rows": 0, "ids": 0, "score_bits": 0}}
    for i, q1 in enumerate(qs):
        q, m = _padded([q1])
        base = flush_rows[i // SERVE_BATCH]
        row = i % SERVE_BATCH
        ids0 = base.doc_ids[row].cpu().numpy()
        sc0 = base.scores[row].cpu().numpy().view(np.uint32)
        for key, (qq, mm) in (("b1", (q, m)), ("padded_miss_lane", (
                np.repeat(q, SERVE_BATCH, 0), np.repeat(m, SERVE_BATCH, 0)))):
            r = teng.retrieve_timeline(tl, qq, cfg, mm)
            ids = r.doc_ids[0].cpu().numpy()
            sc = r.scores[0].cpu().numpy().view(np.uint32)
            d_ids, d_sc = int((ids != ids0).sum()), int((sc != sc0).sum())
            differ[key]["rows"] += int(d_ids + d_sc > 0)
            differ[key]["ids"] += d_ids
            differ[key]["score_bits"] += d_sc
    if any(v["rows"] for v in differ.values()):
        raise AssertionError(f"a query's row differs by batch: {differ}")

    # a filtered batch through query(), on the timeline with a plane
    names = tuple(FILTER_PREDICATES)
    rates = dict(enumerate(FILTER_PREDICATES.values()))
    planed = tstore.ShardedTimeline(
        (filt["index"],) + tuple(
            g._replace(pred_words=predicate_words(g.codes.shape[0], rates,
                                                  10 + i, g.device))
            for i, g in enumerate(tl.generations[1:])),
        tuple(dataclasses.replace(m, pred_names=names) for m in tl.metas))
    plan = bitvector.compile_filter(bitvector.Pred("p1"), names)
    fsvc = RetrievalService(planed, cfg, max_batch=SERVE_BATCH)
    fq = tlres["queries"][:32].cpu().numpy()
    fres = [fsvc.query(fq, doc_filter=plan) for _ in range(2)]
    fwant = teng.retrieve_timeline(planed, fq, cfg, doc_filter=plan)
    if not all(_same_result(r, fwant) for r in fres):
        raise AssertionError("filtered query() differs from "
                             "retrieve_timeline with the filter")
    passing = torch.cat([bitvector.apply_filter_plan(plan, g.pred_words)
                         for g in planed.generations])
    fin = torch.isfinite(fwant.scores)
    if not passing[fwant.doc_ids[fin].long()].all():
        raise AssertionError("a finite filtered result fails the filter")
    del fsvc, planed

    # a hot swap staged behind pending tickets, then add_passages; queries
    # planted on the new docs
    new_t = synthetic.make_raw_docs(index, BUILD_SEED + 2,
                                    SWAP_DOCS + ADD_DOCS, MIN_LEN)
    new_embs, new_lens = (t.cpu().numpy() for t in new_t)
    fresh = synthetic.make_raw_queries(*new_t, BUILD_SEED + 5,
                                       SWAP_PENDING + SERVE_BATCH,
                                       ENGINE["n_q"])[0].cpu().numpy()
    pending = [svc.submit(q) for q in fresh[:SWAP_PENDING]]
    t0 = time.perf_counter()
    svc.new_generation(new_embs[:SWAP_DOCS], new_lens[:SWAP_DOCS])
    stage_s = time.perf_counter() - t0
    if len(svc.timeline) != len(tl):
        raise AssertionError("the swap installed with tickets pending")
    t0 = time.perf_counter()
    svc.flush()
    flush_s = time.perf_counter() - t0
    q, m = _padded(list(fresh[:SWAP_PENDING]))
    if not _tickets_equal(pending, teng.retrieve_timeline(tl, q, cfg, m)):
        raise AssertionError("pending tickets were not answered against "
                             "the snapshot they were accepted under")
    if len(svc.timeline) != len(tl) + 1 or svc.metrics.deferred_swaps != 1:
        raise AssertionError("the staged swap did not install at the flush")
    t0 = time.perf_counter()
    svc.add_passages(new_embs[SWAP_DOCS:], new_lens[SWAP_DOCS:])
    add_s = time.perf_counter() - t0
    q16 = fresh[SWAP_PENDING:]
    if not _same_result(svc.query(q16),
                        teng.retrieve_timeline(svc.timeline, q16, cfg)):
        raise AssertionError("after add_passages the service differs from "
                             "retrieve_timeline")
    # cached rows of one batch against an uncached run of another: the
    # immutable generations' partials of q16 and of the pending tickets are
    # cached, each computed in its own batch; this batch mixes them in
    # another order with queries new to this service's cache
    mixed = np.concatenate([q16[8:], fresh[:SWAP_PENDING][::-1],
                            tlres["queries"][32:36].cpu().numpy(),
                            q16[:3]])
    hits = svc.cache.hits
    if not _same_result(svc.query(mixed),
                        teng.retrieve_timeline(svc.timeline, mixed, cfg)):
        raise AssertionError("cached rows of other batches differ from an "
                             "uncached run of this batch")
    mixed_hits = svc.cache.hits - hits
    if mixed_hits == 0:
        raise AssertionError("the mixed batch hit no cached row")

    # compaction: generations 1-2 merge; under lossless budgets the results
    # are the same before and after
    lossless = dataclasses.replace(cfg, **MERGE_BUDGETS)
    msvc = RetrievalService(svc.timeline, lossless, max_batch=SERVE_BATCH)
    before = msvc.query(q16)
    merges = {}
    for name, s in (("service", svc), ("lossless", msvc)):
        t0 = time.perf_counter()
        acts = MaintenanceRunner(s, MaintenancePolicy(merge_factor=2)) \
            .run_once()
        merges[name] = time.perf_counter() - t0
        if [(a.kind, a.lo, a.hi) for a in acts] != [("merge", 1, 3)]:
            raise AssertionError(f"maintenance on the {name} service: "
                                 f"{acts}, expected the merge of [1, 3)")
    if not _same_result(msvc.query(q16), before):
        raise AssertionError("results differ after the merge")
    if not _same_result(svc.query(q16),
                        teng.retrieve_timeline(svc.timeline, q16, cfg)):
        raise AssertionError("the merged service differs from "
                             "retrieve_timeline")
    del msvc

    # drift: a generation whose tokens moved away from the centroids, the
    # runner re-epochs it with fresh codebooks built on the card
    for noise in DRIFT_NOISE:
        d_embs, d_lens = (t.cpu().numpy() for t in synthetic.make_raw_docs(
            index, BUILD_SEED + 3, DRIFT_DOCS, MIN_LEN, token_noise=noise))
        drift = tstore.new_generation(index, meta, d_embs[:256],
                                      d_lens[:256])[1].drift
        if drift > MaintenancePolicy().drift_threshold:
            break
    else:
        raise AssertionError(f"no token noise of {DRIFT_NOISE} drifts")
    if int(d_lens.sum()) < MIN_TRAIN_TOKENS:
        raise AssertionError("the drifted generation is too small to train")
    svc.new_generation(d_embs, d_lens)
    start = svc.timeline.offsets[-1]
    served_drift = svc.timeline.metas[-1].drift
    fetched = []

    def fetch(a, b):
        fetched.append((a, b))
        return d_embs[a - start:b - start], d_lens[a - start:b - start]
    t0 = time.perf_counter()
    acts = MaintenanceRunner(svc, MaintenancePolicy(), fetch_embeddings=fetch,
                             build_seed=BUILD_SEED).run_once()
    torch.cuda.synchronize()
    reepoch_s = time.perf_counter() - t0
    if [a.kind for a in acts] != ["reepoch"] or fetched != [
            (start, start + DRIFT_DOCS)] or len(svc.epoched) != 2:
        raise AssertionError(f"re-epoch: {acts}, fetched {fetched}")
    # queries no generation has cached, so every lane holds the whole batch
    dq, dgt = synthetic.make_raw_queries(
        torch.from_numpy(d_embs), torch.from_numpy(d_lens), BUILD_SEED + 4,
        2 * SERVE_BATCH, ENGINE["n_q"])
    eq = dq.numpy()
    eres = svc.query(eq)
    if not _same_result(eres, teng.retrieve_timeline(svc.epoched, eq, cfg)):
        raise AssertionError("the epoched service differs from "
                             "retrieve_timeline")
    new_epoch = svc.epoched.epochs[-1]
    d_ids = eres.doc_ids.cpu().numpy()
    found = float(np.mean([start + g in r for g, r in
                           zip(dgt.numpy(), d_ids)]))

    stats = svc.stats()
    text = svc.exposition()
    errors = _lint_exposition(text)
    if errors:
        raise AssertionError(f"exposition: {errors[:5]}")
    emit("serving", queries=len(qs), terms=[len(q) for q in qs[:8]],
         max_batch=SERVE_BATCH, launches=launches,
         tickets_equal_padded_batch=True, warm_equals_cold=True,
         cold_ms_per_query=_ms_stats(cold_ms),
         warm_ms_per_query=_ms_stats(warm_ms),
         flush_latency=traffic["latency"],
         cold_flush_latency=traffic["cold_latency"],
         warm_flush_latency=traffic["warm_latency"],
         cache_after_warm=traffic["cache"], batch_invariance=differ,
         mixed_batch={"queries": len(mixed), "cache_hits": mixed_hits,
                      "equal_uncached_run": True},
         filtered={"predicate": "p1", "equal": True,
                   "fillers": int((~fin).sum())},
         swap={"stage_seconds": stage_s, "flush_seconds": flush_s,
               "add_passages_seconds": add_s,
               "pending_answered_on_old_snapshot": True},
         merge_seconds=merges, merge_equal_before_after=True,
         drift={"token_noise": noise, "drift_first_256": drift,
                "drift": served_drift, "real_tokens": int(d_lens.sum())},
         reepoch={"seconds": reepoch_s, "docs": DRIFT_DOCS,
                  "epochs": len(svc.epoched),
                  "n_centroids": new_epoch.metas[0].n_centroids,
                  "drift_after": new_epoch.metas[0].drift,
                  "planted_found_at_100": found, "served_equal": True},
         service_latency=stats["latency"], cache=stats["cache"],
         maintenance=stats["maintenance"], timeline=stats["timeline"],
         exposition_lines=len(text.splitlines()), exposition_valid=True)
    return {"launches": launches, "fingerprints": fingerprints}


# --- 5e. invariance: a query's CS and LUT bits in any batch -----------------

# (n_centroids, d, n_q, m, nbits): the width where one product over the
# batch was not invariant, and the emvb-msmarco d, n_q, m, nbits over 4,096
# centroids; 2^18 centroids is the full index itself.
INVARIANCE_WIDTHS = ((512, 32, 16, 4, 4), (4096, 128, 32, 16, 8))
INVARIANCE_BATCHES = (1, 2, 4, 8, 16, 17)


def invariance_phase(full: dict) -> dict:
    """Phase 5e: at each width of INVARIANCE_WIDTHS (a 3,000-doc planted
    index) and on the full index (2^18 centroids), in float32 and bf16, the
    CS and LUT elements that differ between B rows computed in a batch of B
    and the same rows in a batch of 32 (its first B rows, and its last B),
    for B in INVARIANCE_BATCHES: every count must be 0. Beside them, the
    counts of one product over the whole batch (``torch.matmul`` of
    (B, n_q, d) by the table, the form before the per-query product), which
    are not held, and the ms of both forms at B = 32 and B = 1 (L2
    flushed)."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.core.precision import CS_DTYPES
    from repro_torch.data import synthetic
    index0 = full["index"]
    dev = index0.device
    widths = [(w, synthetic.make_packed_index(
        0, n_docs=3000, cap=16, min_len=6, d=w[1], n_centroids=w[0], m=w[3],
        nbits=w[4], list_cap=None, device=dev)[0]) for w in INVARIANCE_WIDTHS]
    widths.append(((WIDTHS["n_centroids"], WIDTHS["d"], ENGINE["n_q"],
                    WIDTHS["m"], WIDTHS["nbits"]), index0))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    counts, one_gemm, ms = {}, {}, {}
    for (n_c, d, n_q, _, _), index in widths:
        q, _ = synthetic.make_queries(index, 1, 32, n_q)
        lut = teng._query_lut(index, q).view(torch.int32)
        for dtype in ("float32", "bfloat16"):
            key = f"n_c={n_c},d={d},n_q={n_q},{dtype}"
            dt = CS_DTYPES[dtype]

            def batched(x):
                return torch.matmul(x.to(dt), index.centroids.T.to(dt))
            cs = teng.centroid_scores(q, index.centroids, dtype)
            one = batched(q)
            counts[key], one_gemm[key] = {}, {}
            for b in INVARIANCE_BATCHES:
                # the first b rows, and the last b (at other positions in
                # the batch of b than in the batch of 32)
                rows = (slice(0, b), slice(32 - b, 32))
                counts[key][b] = {
                    "cs_elements_differing": sum(int((teng.centroid_scores(
                        q[r], index.centroids, dtype).view(torch.int16)
                        != cs[r].view(torch.int16)).sum()) for r in rows),
                    "lut_elements_differing": sum(int((teng._query_lut(
                        index, q[r]).view(torch.int32) != lut[r]).sum())
                        for r in rows),
                    "cs_elements": 2 * cs[:b].numel()}
                one_gemm[key][b] = sum(int((batched(q[r]).view(torch.int16)
                                            != one[r].view(torch.int16)
                                            ).sum()) for r in rows)
            if n_c == WIDTHS["n_centroids"]:
                for name, x in (("b32", q), ("b1", q[:1])):
                    ms[f"{dtype}_{name}"] = {
                        "per_query_products": time_ms(
                            lambda x=x: teng.centroid_scores(
                                x, index.centroids, dtype), flush=flush),
                        "one_product": time_ms(lambda x=x: batched(x),
                                               flush=flush)}
    bad = {k: {b: c for b, c in v.items()
               if c["cs_elements_differing"] or c["lut_elements_differing"]}
           for k, v in counts.items()}
    emit("invariance", counts=counts, one_product_cs_elements_differing=
         one_gemm, cs_ms=ms, nvidia_smi=RECORD["device"]["nvidia_smi"])
    if any(bad.values()):
        raise AssertionError(f"CS or LUT rows differ by batch: {bad}")
    return {"counts": counts, "cs_ms": ms}


# --- 5f. PLAID at full width -------------------------------------------------

PLAID_CFG = dict(k=100, n_docs=100, nprobe=4)  # table1_msmarco.py:32, k = 100
PLAID_SAMPLE_DOCS = 1 << 16   # docs whose S̄ the plain version recomputes


def cinter_corpus_bound(n_docs: int, tokens: int, rows: int, n_q: int
                        ) -> dict:
    """Least bytes one whole-corpus cinter launch must move: every doc's
    length and valid-token codes, the CS^T rows the corpus' tokens touch
    (``rows`` distinct centroids), the term mask and S̄ out; one max per
    (valid token, term)."""
    return _bound(n_docs * 4 + tokens * 4 + rows * n_q * 4 + n_q
                  + n_docs * 4, tokens * n_q)


def plaid_phase(full: dict, build: dict) -> dict:
    """Phase 5f: the PLAID baseline at full width. The planted index gains
    b = 2 PLAID residuals made on the card (synthetic.with_plaid_residuals);
    plaid.retrieve at B = 32 and B = 1 with the launch counts read around
    those calls (cinter once a query, nothing else); the four phases of
    the first batch and of one query composed to retrieve's result; each
    query's whole-corpus cinter launch held exactly against
    cinter_batched_ref on the first PLAID_SAMPLE_DOCS docs and every
    selected doc; planted Success@100 and MRR@10; ms per phase and end to
    end beside EMVB fused on the same queries, in turns; cinter's
    whole-corpus ms beside its bound; then PLAID and EMVB fused on the
    trained index of index_build (real residuals), MRR@10 and Success@100
    for both."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.core import plaid
    from repro_torch.core.topk import topk
    from repro_torch.data import synthetic
    from repro_torch.kernels import cinter as kci
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, meta = synthetic.with_plaid_residuals(full["index"], full["meta"])
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    pcfg = plaid.PlaidConfig(n_q=ENGINE["n_q"], **PLAID_CFG)
    cfg = full["cfg"]
    queries, gt = full["queries"], full["gt"]
    batches = [queries[s:s + 32] for s in range(0, N_QUERIES, 32)]
    n_docs = index.codes.shape[0]
    ops.reset_launches()
    res = [plaid.retrieve(index, q, pcfg) for q in batches]
    torch.cuda.synchronize()
    launches = {"b32": ops.launch_counts()}
    ops.reset_launches()
    res1 = [plaid.retrieve(index, queries[i:i + 1], pcfg)
            for i in range(N_SINGLE)]
    torch.cuda.synchronize()
    launches["b1"] = ops.launch_counts()
    for b, want in (("b32", N_QUERIES), ("b1", N_SINGLE)):
        got = {k: v for k, v in launches[b].items() if v}
        if got != {"cinter": want}:
            raise AssertionError(f"plaid {b}: launches {launches[b]}, "
                                 f"expected cinter {want}x and no other")
    ids = torch.cat([r.doc_ids for r in res])
    scores = torch.cat([r.scores for r in res])
    if ids.shape != (N_QUERIES, pcfg.k) or not torch.isfinite(scores).all() \
            or not (scores[:, :-1] >= scores[:, 1:]).all() \
            or not ((ids >= 0) & (ids < n_docs)).all():
        raise AssertionError("plaid.retrieve returned malformed results")
    gt_np, ids_np = gt.cpu().numpy(), ids.cpu().numpy()
    ids1_np = torch.cat([r.doc_ids for r in res1]).cpu().numpy()
    quality = {"success_at_100": synthetic.success_at_k(ids_np, gt_np, 100),
               "mrr_at_10": synthetic.mrr_at_k(ids_np, gt_np, 10),
               "success_at_100_b1": synthetic.success_at_k(
                   ids1_np, gt_np[:N_SINGLE], 100),
               "b1_rows_equal_b32": int(sum(
                   (ids1_np[i] == ids_np[i]).all()
                   for i in range(N_SINGLE)))}

    # the phases composed, and every whole-corpus cinter launch held
    held, err = {}, 0.0
    for name, q, ref in (("b32", batches[0], res[0]),
                         ("b1", queries[:1], res1[0])):
        cs, bitmap = plaid.phase_retrieval(index, q, pcfg)
        sel2 = plaid.phase_filtering(index, cs, bitmap, pcfg)
        emb = plaid.phase_decompression(index, sel2)
        top, pids = plaid.phase_late_interaction(index, q, emb, sel2,
                                                 pcfg.k)
        if not _same_result(teng.RetrievalResult(top, pids), ref):
            raise AssertionError(f"plaid {name}: the phases do not compose "
                                 "to retrieve's result")
        cs_t = teng._transposed(cs)
        first = torch.arange(PLAID_SAMPLE_DOCS, device=index.device)
        for b in range(q.shape[0]):
            sbar = ops.cinter(cs_t[b], index.codes, index.doc_lens)
            docs = torch.unique(torch.cat([first, sel2[b].long()]))
            want = kci.cinter_batched_ref(
                cs_t[b][None], index.codes[docs][None],
                index.doc_lens[docs][None])[0]
            err = max(err, _exact((sbar[docs],), (want,)))
            cand = torch.where(bitmap[b], sbar, -torch.inf)
            if not torch.equal(sel2[b].long(), topk(cand, pcfg.n_docs)[1]):
                raise AssertionError(f"plaid {name}: the cut is not the "
                                     "top n_docs of the kernel's S̄")
        held[name] = dict(cs_t=cs_t, bitmap=bitmap, sel2=sel2, emb=emb,
                          candidates=bitmap.sum(1).tolist()[:4])

    # ms: each phase, end to end, and EMVB fused on the same queries
    flush = torch.empty(64 << 20, dtype=torch.int32, device=index.device)
    hist = full["token_hist"]
    tokens = int(hist.sum())
    rows = int((hist > 0).sum())
    timing = {}
    for name, q in (("b32", batches[0]), ("b1", queries[:1])):
        h = held[name]
        cs = h["cs_t"].transpose(1, 2)
        n = 6 if name == "b32" else 20
        steps = {
            "retrieval": lambda: plaid.phase_retrieval(index, q, pcfg),
            "filtering": lambda: plaid.phase_filtering(index, cs,
                                                       h["bitmap"], pcfg),
            "decompression": lambda: plaid.phase_decompression(index,
                                                               h["sel2"]),
            "late_interaction": lambda: plaid.phase_late_interaction(
                index, q, h["emb"], h["sel2"], pcfg.k)}
        ms = {k: time_ms(fn, n=n, warmup=1, flush=flush)
              for k, fn in steps.items()}
        turns = in_turns({"plaid": lambda: plaid.retrieve(index, q, pcfg),
                          "emvb_fused": lambda: teng.retrieve(index, q, cfg)},
                         n=2 * n, rounds=2 if name == "b32" else 5,
                         flush=flush)
        timing[name] = {"phase_ms": ms, "plaid_end_to_end": {
            k: v for k, v in turns.items() if k != "emvb_fused_in_turns"},
            "emvb_fused_end_to_end": turns["emvb_fused_in_turns"],
            "plaid_over_emvb": turns["median_ms"]
            / turns["emvb_fused_in_turns"]["median_ms"]}
    cs_t0 = held["b1"]["cs_t"][0]
    sample = torch.arange(PLAID_SAMPLE_DOCS, device=index.device)
    s_args = (cs_t0[None], index.codes[:PLAID_SAMPLE_DOCS][None],
              index.doc_lens[:PLAID_SAMPLE_DOCS][None])
    cinter = {
        "ms": time_ms(lambda: ops.cinter(cs_t0, index.codes,
                                         index.doc_lens), flush=flush),
        "docs": n_docs,
        "bound": cinter_corpus_bound(n_docs, tokens, rows, ENGINE["n_q"]),
        "sample_docs": int(sample.numel()),
        "ms_sample": time_ms(lambda: ops.cinter_batched(*s_args),
                             flush=flush),
        "plain_ms_sample": time_ms(lambda: kci.cinter_batched_ref(*s_args),
                                   n=5, warmup=1, flush=flush),
        "launches": [launches["b32"]["cinter"], launches["b1"]["cinter"]],
        "max_abs_err": err}
    fb = _field_bytes(index)
    emit("plaid", config=PLAID_CFG, residual_b=meta.plaid_b,
         plaid_res_gb=fb["plaid_res"] / 1e9, make_residuals_seconds=make_s,
         codec={"cutoffs": index.plaid_cutoffs.tolist(),
                "weights": index.plaid_weights.tolist()},
         launches=launches, quality=quality, phases_compose=True,
         cinter_corpus=cinter, timing=timing,
         candidates_first_queries=held["b32"]["candidates"],
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         nvidia_smi=RECORD["device"]["nvidia_smi"])
    if quality["success_at_100"] < SUCCESS_FLOOR:
        raise AssertionError(f"plaid: planted Success@100 "
                             f"{quality['success_at_100']} < {SUCCESS_FLOOR}")
    del index, held, res, res1
    torch.cuda.empty_cache()

    # the trained index (real residuals): PLAID and EMVB fused
    tix, tq, tgt = build["index"], build["queries"], build["gt"]
    tb = [tq[s:s + 32] for s in range(0, N_QUERIES, 32)]
    trained = {}
    for name, fn in (("plaid", lambda q: plaid.retrieve(tix, q, pcfg)),
                     ("emvb_fused", lambda q: teng.retrieve(tix, q, cfg))):
        got = torch.cat([fn(q).doc_ids for q in tb]).cpu().numpy()
        g = tgt.cpu().numpy()
        trained[name] = {"mrr_at_10": synthetic.mrr_at_k(got, g, 10),
                         "success_at_100": synthetic.success_at_k(got, g,
                                                                  100),
                         "ms_b32": time_ms(lambda: fn(tb[0]), n=5,
                                           warmup=1, flush=flush)}
    emit("plaid_trained", docs=tix.codes.shape[0], queries=N_QUERIES,
         **trained)
    return {"launches": launches, "cinter": cinter, "timing": timing,
            "quality": quality, "trained": trained}


# --- 5g. explain at full width -----------------------------------------------

def explain_phase(full: dict, filt: dict, tlres: dict,
                  fingerprints: tuple) -> dict:
    """Phase 5g: explain one planted query at full width on both lanes,
    unfiltered, with the 1 % filter (the filter phase's plane) and in
    compact mode, and explain_timeline on the timeline (its generations'
    fingerprints the serving phase's service computed); the launch counts
    read around the explains alone; each top-k equal to retrieve's (or
    retrieve_timeline's) ids and score bits, contributions summing to k;
    the funnel counts and phase_ms."""
    import numpy as np
    import torch
    from repro_torch.core import bitvector
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    from repro_torch.obs import explain
    q = full["queries"][0]
    plan = bitvector.compile_filter(bitvector.Pred("p1"),
                                    tuple(FILTER_PREDICATES))
    cases = {}
    for lane, c in (("fused", full["cfg"]), ("unfused", full["ucfg"])):
        cases[f"{lane}"] = (full["index"], c)
        cases[f"{lane}_filter1pct"] = (filt["index"], dataclasses.replace(
            c, doc_filter=plan))
        cases[f"{lane}_compact"] = (full["index"], dataclasses.replace(
            c, candidate_mode="compact", cand_cap=CAND_CAP))
    tl = tlres["timeline"]
    tl.__dict__["fingerprints"] = tuple(fingerprints)
    ops.reset_launches()
    reports = {name: explain.explain(ix, q, c)
               for name, (ix, c) in cases.items()}
    trpt = explain.explain_timeline(tl, q, full["cfg"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    n_exp = len(cases) + len(tl)
    want = {"bitpack": n_exp, "bitfilter": n_exp, "cinter": n_exp,
            "pqscore": n_exp, "prefilter": len(tl), "pqinter": len(tl),
            # phase 1 and the report's probes of each explain, and the
            # timeline's retrieve a generation
            "topnprobe": 2 * n_exp + len(tl)}
    if launches != want:
        raise AssertionError(f"explain: launches {launches}, expected {want}")
    out = {}
    for name, rpt in reports.items():
        ix, c = cases[name]
        ref = teng.retrieve(ix, q[None], c)
        if not (torch.equal(torch.from_numpy(rpt.topk_ids),
                            ref.doc_ids[0].cpu())
                and torch.equal(torch.from_numpy(rpt.topk_scores).view(
                    torch.int32), ref.scores[0].cpu().view(torch.int32))):
            raise AssertionError(f"explain {name}: top-k differs from "
                                 "retrieve's")
        d = rpt.to_dict()
        out[name] = {k: v for k, v in d.items()
                     if k not in ("topk_ids", "topk_scores")}
    ref = teng.retrieve_timeline(tl, q[None], full["cfg"])
    if not (np.array_equal(trpt.topk_ids, ref.doc_ids[0].cpu().numpy())
            and np.array_equal(trpt.topk_scores.view(np.uint32),
                               ref.scores[0].cpu().numpy().view(np.uint32))):
        raise AssertionError("explain_timeline: top-k differs from "
                             "retrieve_timeline's")
    contrib = [g.contribution for g in trpt.generations]
    if sum(contrib) != full["cfg"].k:
        raise AssertionError(f"explain_timeline: contributions {contrib} "
                             f"do not sum to k={full['cfg'].k}")
    emit("explain", launches=launches, topk_equal_retrieve=True,
         funnels=out, timeline={
             "contributions": contrib, "merge_ms": trpt.merge_ms,
             "funnels": [{k: v for k, v in g.funnel.to_dict().items()
                          if k not in ("topk_ids", "topk_scores")}
                         for g in trpt.generations]})
    return {"launches": launches}


# --- 5h. the distributed plan ------------------------------------------------

DIST_DOCS = 1 << 22   # docs of the two-rank run: each rank holds the planted
#                       index and its two local IVFs (4.3 GB each at
#                       2^18 x 4096 slots); run before the full index is made


def _dist_rank(rank: int, world: int, init_file: str, out_dir: str,
               device: str = "cuda") -> None:
    """One of ``world`` ranks on the one card, over gloo: the planted index
    at DIST_DOCS docs (same seed on every rank), shard_index(index, world),
    the sharded plan at B = 32 and B = 1 against the two-level top-k
    composed on the card from each shard's retrieve and topk; its result in
    rank<r>.json."""
    _import_port()
    import torch
    import torch.distributed as dist
    from repro_torch.core import engine as teng
    from repro_torch.core.topk import topk
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    widths = {**WIDTHS, "n_docs": DIST_DOCS}
    index, _ = synthetic.make_packed_index(0, min_len=MIN_LEN, device=device,
                                           **widths)
    q, _ = synthetic.make_queries(index, 1, 32, ENGINE["n_q"])
    cfg = teng.EngineConfig(**ENGINE, use_kernels=True)
    stacked = serve.shard_index(index, world, device=device)
    run = serve.make_shardmap_retriever(None, cfg, device=device)
    ops.reset_launches()
    got = {b: run(stacked, x) for b, x in (("b32", q), ("b1", q[:1]))}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    per = DIST_DOCS // world
    equal = {}
    for b, x in (("b32", q), ("b1", q[:1])):
        parts = [teng.retrieve(serve._shard(stacked, s), x, cfg,
                               device=device) for s in range(world)]
        sc = torch.cat([p.scores for p in parts], 1)
        ids = torch.cat([p.doc_ids + s * per for s, p in enumerate(parts)],
                        1)
        top, pos = topk(sc, cfg.k)
        equal[b] = _same_result(got[b], teng.RetrievalResult(
            top, torch.gather(ids, 1, pos)))
    dist.barrier()
    ms = time_ms(lambda: run(stacked, q), n=5, warmup=1)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"equal": equal, "launches": launches, "ms_b32": ms,
                   "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9
                   if torch.cuda.is_available() else None}, f)
    dist.destroy_process_group()


def two_ranks_phase() -> list:
    """Phase 3b (the distributed plan, first half): two ranks spawned on
    the one card over gloo (NCCL refuses two ranks on one device) at
    DIST_DOCS docs, run while nothing else is resident, each equal to the
    two-level top-k composed on the card (:func:`_dist_rank`). -> each
    rank's record."""
    import tempfile

    import torch
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_dist_rank, args=(2, f"{tmp}/init", tmp), nprocs=2,
                 join=True)
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    if not all(all(r["equal"].values()) for r in ranks):
        raise AssertionError(f"two gloo ranks differ from the composed "
                             f"two-level top-k: {ranks}")
    emit("distributed_two_ranks", backend="gloo", docs=DIST_DOCS,
         seconds=seconds, ranks=ranks)
    return ranks


def distributed_phase(full: dict, tlres: dict, fingerprints: tuple,
                      two_ranks: list) -> dict:
    """Phase 5h: the sharded serving plan at world size 1 over NCCL at full
    width: make_shardmap_retriever over shard_index(index, 1) equal to
    retrieve (ids and score bits) at B = 32 and B = 1, the launch counts
    read around those calls; make_timeline_retriever equal to
    retrieve_timeline and make_service equal to RetrievalService on the
    timeline (its generations' fingerprints the serving phase's service
    computed), cold and warm. ``two_ranks``: phase 3b's records."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import RetrievalService
    index, cfg = full["index"], full["cfg"]
    queries = full["queries"]
    batches = [queries[s:s + 32] for s in range(0, N_QUERIES, 32)]
    tl = tlres["timeline"]
    tl.__dict__["fingerprints"] = tuple(fingerprints)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            t0 = time.perf_counter()
            stacked = serve.shard_index(index, 1)
            torch.cuda.synchronize()
            shard_s = time.perf_counter() - t0
            run = serve.make_shardmap_retriever(None, cfg)
            ops.reset_launches()
            got = [run(stacked, q) for q in batches]
            torch.cuda.synchronize()
            launches = {"b32": ops.launch_counts()}
            ops.reset_launches()
            got1 = [run(stacked, queries[i:i + 1]) for i in range(N_SINGLE)]
            torch.cuda.synchronize()
            launches["b1"] = ops.launch_counts()
            for b, n in (("b32", len(batches)), ("b1", N_SINGLE)):
                want = {"prefilter": n, "pqinter": n, "topnprobe": n}
                if {k: v for k, v in launches[b].items() if v} != want:
                    raise AssertionError(f"distributed {b}: launches "
                                         f"{launches[b]}, expected {want}")
            for r, q in zip(got + got1, batches + [
                    queries[i:i + 1] for i in range(N_SINGLE)]):
                if not _same_result(r, teng.retrieve(index, q, cfg)):
                    raise AssertionError("the one-rank sharded plan differs "
                                         "from retrieve")
            del stacked
            tq = tlres["queries"][:32]
            trun = serve.make_timeline_retriever(None, cfg, tl)
            for x in (tq, tq[:1]):
                if not _same_result(trun(x),
                                    teng.retrieve_timeline(tl, x, cfg)):
                    raise AssertionError("make_timeline_retriever differs "
                                         "from retrieve_timeline")
            del trun
            svc = serve.make_service(None, cfg, tl, max_batch=SERVE_BATCH)
            ref = RetrievalService(tl, cfg, max_batch=SERVE_BATCH)
            qn = tq.cpu().numpy()
            for _ in range(2):
                if not _same_result(svc.query(qn), ref.query(qn)):
                    raise AssertionError("make_service differs from "
                                         "RetrievalService")
            hits = svc.cache.hits
            del svc, ref
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit("distributed", one_rank={"backend": "nccl", "launches": launches,
                                  "shard_index_seconds": shard_s,
                                  "equal_retrieve": True,
                                  "timeline_equal": True,
                                  "service_equal": True,
                                  "service_warm_hits": hits},
         two_ranks={"backend": "gloo", "docs": DIST_DOCS,
                    "equal": True,
                    "launches": [r["launches"] for r in two_ranks]})
    return {"launches": launches, "two_ranks": two_ranks}


# --- 5i. encoder: train, encode, index and retrieve on the card -------------

# The encoder's run, at colbert.make_config()'s defaults: the token-pair
# generator over the whole vocabulary (24 words a topic: 1,271 topics),
# passages of the index's cap, queries of ENGINE's n_q terms.
ENCODER = dict(
    seed=11, words_per_topic=24, batch=32, steps=200, resume_at=100,
    jmpq_steps=20, lr=3e-3, loss_window=20, docs=32_768, encode_batch=1024,
    time_docs=1024, time_reps=10, variance_batches=(1, 16, 17, 32))
# ColBERTv2's published encoder (BERT-base): 12 layers, d_model 768, 12
# heads x 64, d_ff 3072, the BERT vocabulary, projected to 128.
COLBERTV2 = dict(n_layers=12, d_model=768, n_heads=12, d_head=64, d_ff=3072,
                 vocab=30_522, out_dim=128)
BF16_OPS_PER_S = 989e12   # H100 SXM data sheet, dense bf16 tensor cores
RESUME_RTOL = 1e-4        # the resumed run's losses, were it not bit-equal


def _differing(a, b) -> int:
    """Elements of two float32 tensors whose bits differ."""
    import torch
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def encode_flops(cfg, b: int, s: int) -> int:
    """Model operations of encoding b sequences of s tokens: the weight
    products, QK^T and PV over all s keys, and the projection."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    d, f = cfg.d_model, cfg.d_ff
    layer = (2 * d * h * dh + 4 * d * kv * dh + 2 * h * dh * d + 6 * d * f
             + 4 * s * h * dh)
    return b * s * (cfg.n_layers * layer + 2 * d * cfg.out_proj)


def train_flops(cfg, b: int, sq: int, sd: int) -> int:
    """A contrastive step's model operations: forward and backward (3x) of
    both encodes and of the (b, b) MaxSim product."""
    return 3 * (encode_flops(cfg, b, sq) + encode_flops(cfg, b, sd)
                + 2 * b * b * sq * sd * cfg.out_proj)


def _pairs(vocab: int, batch: int):
    """The encoder's token-pair batches (synthetic.token_pairs)."""
    from repro_torch.data import synthetic
    w = ENCODER["words_per_topic"]
    return synthetic.token_pairs(
        ENCODER["seed"], n_topics=vocab // w, words_per_topic=w, vocab=vocab,
        batch=batch, q_len=ENGINE["n_q"], d_len=WIDTHS["cap"])


def _loss(pq_codebooks=None):
    from repro_torch.models import colbert

    def loss(p, b):
        return colbert.contrastive_loss(p, b, p.cfg,
                                        pq_codebooks=pq_codebooks)
    return loss


def _trainer(model, make_batch, ckpt_dir=None, pq_codebooks=None):
    """AdamW at ENCODER's lr over ``make_batch``, logging every step."""
    from repro_torch.train import optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    return Trainer(_loss(pq_codebooks),
                   optimizer.make("adamw", lr=ENCODER["lr"]), make_batch,
                   TrainerConfig(ckpt_dir=ckpt_dir,
                                 ckpt_every=ENCODER["resume_at"],
                                 log_every=1), model, device=model.device)


def step_determinism(model, batch) -> dict:
    """The training step's stages run twice from one state on one batch:
    the elements of the loss, of each gradient leaf and of the AdamW
    update that differ the second time (all 0: deterministic)."""
    from repro_torch.core.precision import exact_matmuls
    from repro_torch.models import transformer as ttr
    from repro_torch.train import optimizer
    from repro_torch.train import trainer as ttrainer
    opt = optimizer.make("adamw", lr=ENCODER["lr"])
    params = ttr.to_reference_layout(model)
    runs = []
    for _ in range(2):
        with exact_matmuls():
            loss, grads = ttrainer._value_and_grad(_loss(), model, batch)
            new, _ = opt.update(grads, opt.init(params), params)
        runs.append((loss, grads, new))
    (l1, g1, n1), (l2, g2, n2) = runs
    return {"loss": _differing(l1, l2),
            "gradients": {"__".join(p): _differing(g1[p], g2[p])
                          for p in g1 if _differing(g1[p], g2[p])},
            "update": sum(_differing(n1[p], n2[p]) for p in n1)}


def _encode_all(model, tokens, valid, batch: int):
    """Embeddings of every row, ``batch`` rows an encode call."""
    import torch
    out = torch.empty((*tokens.shape, model.cfg.out_proj),
                      dtype=model.cfg.dtype, device=model.device)
    with torch.no_grad():
        for s in range(0, tokens.shape[0], batch):
            out[s:s + batch] = model(tokens[s:s + batch], valid[s:s + batch])
    return out


def exact_maxsim_top(queries, embs, valid, k: int):
    """Each query's top-k docs by exact MaxSim over the whole corpus on the
    card, one query at a time (``interaction.maxsim``: a (docs, n_q, cap)
    product, where all queries at once would take ~11 GB) -> (n, k)."""
    import torch
    from repro_torch.core import interaction
    return torch.stack([torch.topk(interaction.maxsim(q, embs, valid),
                                   k).indices for q in queries])


def _train_step_fn(model, batch):
    """A function running one AdamW step of ``model`` (updated in place)
    on ``batch`` per call."""
    from repro_torch.models import transformer as ttr
    from repro_torch.train import optimizer
    from repro_torch.train.trainer import (TrainerConfig, TrainState,
                                           make_train_step)
    opt = optimizer.make("adamw", lr=ENCODER["lr"])
    step = make_train_step(_loss(), opt, TrainerConfig())
    state = [TrainState(0, model, opt.init(ttr.to_reference_layout(model)))]

    def train_step():
        state[0] = step(state[0], batch)[0]
    return train_step


def encoder_rates(kw: dict, dtype, qtok, dtok) -> dict:
    """CUDA-event medians of an encoder at widths ``kw`` in ``dtype`` (its
    weights drawn from a seed): B = 1 and 32 queries, ENCODER's time_docs
    passages, one training step of ENCODER's batch; tokens/s, peak memory
    and model FLOP/s against the data-sheet peak of ``dtype``."""
    import torch
    from repro_torch.models import colbert
    cfg = colbert.make_config(**kw, dtype=dtype)
    model = colbert.ColBERT(cfg, seed=ENCODER["seed"], device=qtok.device)
    peak = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    nq, cap = ENGINE["n_q"], WIDTHS["cap"]
    qv = torch.ones_like(qtok, dtype=torch.bool)
    dv = torch.ones_like(dtok, dtype=torch.bool)
    out = {"widths": kw, "dtype": str(dtype).split(".")[-1],
           "params": sum(p.numel() for p in model.parameters())}

    def rate(name, fn, flops, tokens):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = statistics.median(time_samples(fn, n=ENCODER["time_reps"]))
        out[name] = {"ms": ms, "tokens_per_second": tokens / ms * 1e3,
                     "flop_per_second": flops / ms * 1e3,
                     "peak_share": flops / ms * 1e3 / peak,
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9}

    with torch.no_grad():
        for b in (1, 32):
            rate(f"query_b{b}", lambda: model(qtok[:b], qv[:b]),
                 encode_flops(cfg, b, nq), b * nq)
        n = dtok.shape[0]
        rate(f"passages_{n}", lambda: model(dtok, dv),
             encode_flops(cfg, n, cap), n * cap)
    b = ENCODER["batch"]
    rate("train_step", _train_step_fn(model, {
        "q_tokens": qtok[:b], "q_valid": qv[:b], "d_tokens": dtok[:b],
        "d_valid": dv[:b]}), train_flops(cfg, b, nq, cap), b * (nq + cap))
    out["peak_ops_per_second"] = peak
    return out


def encoder_profile(model, qtok, qv, batch) -> dict:
    """torch.profiler over one B = 32 query encode and one training step:
    the device's busy share of the window and its top kernels."""
    import torch

    def encode():
        with torch.no_grad():
            model(qtok[:32], qv[:32])
    out = {}
    smi = RECORD["device"]["nvidia_smi"]
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, fn in (("query_b32", encode),
                     ("train_step", _train_step_fn(model, batch))):
        prof, wall_us = _profiled(fn, 1)
        events = _device_events(prof)
        if not events:
            raise AssertionError("the profiler saw no device time")
        busy_us = sum(_dev_us(e) for e in events)
        with open(os.path.join(OUT_DIR, f"profile_encoder_{name}.txt"),
                  "w") as f:
            f.write(f"{smi}\n" + prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=40) + "\n")
        out[name] = {
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_launches": sum(e.count for e in events),
            "top_kernels_ms": {e.key[:90]: _dev_us(e) / 1e3
                               for e in events[:12]},
            "top_kernels_launches": {e.key[:90]: e.count
                                     for e in events[:12]}}
    return out


def encoder_phase(full: dict) -> dict:
    """Phase 5i: the ColBERT encoder through the port on the card. Train it
    (AdamW, ENCODER's steps) on token pairs over the whole vocabulary; stop
    at resume_at with a checkpoint and resume in a fresh Trainer, equal to
    the continuous run; then JMPQ steps with PQ codebooks trained on its
    embeddings. Encode ENCODER's docs passages, build_index at the
    emvb-msmarco widths (BUILD), encode 64 planted queries and serve them
    on both lanes at B = 32 and B = 1 with launch counts, each kernel held
    against its plain version; MRR@10 beside exact MaxSim. Then the
    encoder's rates at the default and ColBERTv2 widths, its share of a
    served query, its batch variance and its profile."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.core import index as tindex
    from repro_torch.core import pq as tpq
    from repro_torch.data import synthetic
    from repro_torch.models import colbert
    t_phase = time.perf_counter()
    dev = full["index"].device
    enc_cfg = colbert.make_config()
    make_batch = _pairs(enc_cfg.vocab, ENCODER["batch"])
    init = colbert.ColBERT(enc_cfg, seed=ENCODER["seed"], device=dev)

    # 1-2. train, and resume from a checkpoint half way
    t0 = time.perf_counter()
    cont = _trainer(init, make_batch)
    log = cont.run(ENCODER["steps"])["log"]
    train_s = time.perf_counter() - t0
    losses = [m["loss"] for m in log]
    # The untrained encoder already tells most in-batch pairs apart (random
    # token embeddings match a query to its passage by their shared
    # tokens), and the first AdamW steps disturb that before training
    # lowers the loss again; so the loss is held over windows of steps.
    w = ENCODER["loss_window"]
    first_mean, last_mean = (statistics.fmean(losses[:w]),
                             statistics.fmean(losses[-w:]))
    if not last_mean < first_mean:
        raise AssertionError(f"encoder training: the last {w} steps' mean "
                             f"loss {last_mean} is not below the first "
                             f"{w}'s {first_mean}")
    with tempfile.TemporaryDirectory() as d:
        _trainer(init, make_batch, ckpt_dir=d).run(ENCODER["resume_at"])
        resumed = _trainer(init, make_batch, ckpt_dir=d)
        rlog = resumed.run(ENCODER["steps"])["log"]
    if rlog[0]["step"] != ENCODER["resume_at"] + 1:
        raise AssertionError("the fresh Trainer did not resume")
    pairs = list(zip(cont.state.params.parameters(),
                     resumed.state.params.parameters()))
    differing = sum(_differing(a, b) for a, b in pairs)
    rlosses = [m["loss"] for m in rlog]
    closs = losses[ENCODER["resume_at"]:]
    bit_equal = differing == 0 and rlosses == closs
    determinism = step_determinism(init, {
        k: v.to(dev) for k, v in make_batch(0).items()})
    if not bit_equal and not np.allclose(rlosses, closs, rtol=RESUME_RTOL,
                                         atol=0):
        raise AssertionError(f"resumed losses differ from the continuous "
                             f"run's beyond rtol {RESUME_RTOL}: "
                             f"{determinism}")
    encoder = cont.state.params
    probe = make_batch(ENCODER["steps"])
    with torch.no_grad():
        pde = encoder(probe["d_tokens"].to(dev), probe["d_valid"].to(dev))
    books = tpq.train_pq(ENCODER["seed"], pde.reshape(-1, pde.shape[-1]),
                         WIDTHS["m"], nbits=WIDTHS["nbits"], device=dev)
    jmpq = _trainer(encoder, lambda s: make_batch(ENCODER["steps"] + s),
                    pq_codebooks=books.codebooks)
    jlog = jmpq.run(ENCODER["jmpq_steps"])["log"]
    emit("encoder_train", config=dataclasses.asdict(enc_cfg) | {
             "dtype": "float32"}, params=sum(
             p.numel() for p in encoder.parameters()),
         batch=ENCODER["batch"], steps=ENCODER["steps"], lr=ENCODER["lr"],
         q_len=ENGINE["n_q"], d_len=WIDTHS["cap"],
         topics=enc_cfg.vocab // ENCODER["words_per_topic"],
         first_loss=losses[0], last_loss=losses[-1], max_loss=max(losses),
         loss_window=w, first_window_mean=first_mean,
         last_window_mean=last_mean, loss_every_10=losses[::10],
         seconds=train_s,
         ms_per_step=statistics.median(m["sec"] for m in log) * 1e3,
         stragglers=cont.straggler_steps,
         jmpq={"steps": ENCODER["jmpq_steps"], "m": WIDTHS["m"],
               "nbits": WIDTHS["nbits"], "first_loss": jlog[0]["loss"],
               "last_loss": jlog[-1]["loss"],
               "losses": [m["loss"] for m in jlog]})
    emit("encoder_resume", resume_at=ENCODER["resume_at"],
         bit_equal=bit_equal, params_differing=differing,
         losses_equal=rlosses == closs,
         max_loss_rel_diff=max(abs(a - b) / abs(b)
                               for a, b in zip(rlosses, closs)),
         step_stages_differing=determinism)
    del resumed, jmpq, pde

    # 3. encode the corpus and build the index
    tok_np, lens = synthetic.token_corpus(
        ENCODER["seed"] + 1, n_docs=ENCODER["docs"],
        n_topics=enc_cfg.vocab // ENCODER["words_per_topic"],
        words_per_topic=ENCODER["words_per_topic"], vocab=enc_cfg.vocab,
        cap=WIDTHS["cap"], min_len=MIN_LEN)
    tokens = torch.from_numpy(tok_np).to(dev)
    valid = torch.arange(WIDTHS["cap"], device=dev)[None] < \
        torch.from_numpy(lens).to(dev)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = _encode_all(encoder, tokens, valid, ENCODER["encode_batch"])
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    n_tok = int(lens.sum())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, meta = tindex.build_index(ENCODER["seed"], embs.cpu().numpy(),
                                     lens, device=dev, **BUILD)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit("encoder_index", docs=ENCODER["docs"], real_tokens=n_tok,
         encode_seconds=encode_s, encode_tokens_per_second=n_tok / encode_s,
         build_seconds=build_s, build=BUILD, list_cap=meta.list_cap,
         n_dropped=meta.n_dropped, train_quant_mse=meta.train_quant_mse,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)

    # 4. encode planted queries; retrieve on both lanes; exact MaxSim
    q_np, qv_np, gt_np = synthetic.token_queries(
        ENCODER["seed"] + 2, tok_np, lens, n_queries=N_QUERIES,
        q_len=ENGINE["n_q"], vocab=enc_cfg.vocab)
    qtok, qv = torch.from_numpy(q_np).to(dev), torch.from_numpy(qv_np).to(dev)
    queries = _encode_all(encoder, qtok, qv, N_QUERIES)
    gt = torch.from_numpy(gt_np)
    cfg, ucfg = full["cfg"], full["ucfg"]
    launches, results, quality, _ = serve_lanes(
        index, {"fused": cfg, "unfused": ucfg}, queries, gt)
    held, held_u, lanes_equal = hold_lanes(index, cfg, ucfg, queries,
                                           results)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = exact_maxsim_top(queries, embs, valid, ENGINE["k"])
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    ex = exact.cpu().numpy()
    emit("encoder_serve", launches=launches, phases_exact=True,
         unfused_equals_fused=lanes_equal, quality=quality,
         exact_maxsim={"mrr_at_10": synthetic.mrr_at_k(ex, gt_np, 10),
                       "success_at_100": synthetic.success_at_k(
                           ex, gt_np, 100), "seconds": exact_s},
         max_abs_err={b: {**held[b]["err"], **held_u[b]["err"]}
                      for b in ("b32", "b1")})
    del held, held_u, results

    # 5-6. rates at two widths; the encoder beside retrieve
    dtok = tokens[:ENCODER["time_docs"]]
    rates = {"default_float32": encoder_rates(
        {}, torch.float32, qtok, dtok)}
    for name, dt in (("colbertv2_float32", torch.float32),
                     ("colbertv2_bfloat16", torch.bfloat16)):
        rates[name] = encoder_rates(COLBERTV2, dt, qtok, dtok)
        torch.cuda.empty_cache()
    served = {}
    for b in (32, 1):
        for name, idx, q in (("planted", full["index"], full["queries"]),
                             ("encoded", index, queries)):
            served[f"{name}_b{b}_ms"] = statistics.median(time_samples(
                lambda: teng.retrieve(idx, q[:b], cfg),
                n=ENCODER["time_reps"]))
        served[f"encoder_share_b{b}"] = {
            name: r[f"query_b{b}"]["ms"] / (
                r[f"query_b{b}"]["ms"] + served[f"planted_b{b}_ms"])
            for name, r in rates.items()}
    emit("encoder_timing", rates=rates, retrieve_fused=served)

    # 7. batch variance: a query's embedding in a batch of B vs of 32
    with torch.no_grad():
        e32 = encoder(qtok[:32], qv[:32])
        r32 = teng.retrieve(index, e32, cfg)
        variance = {}
        for b in ENCODER["variance_batches"]:
            first = encoder(qtok[:b], qv[:b])
            last = encoder(qtok[32 - b:32], qv[32 - b:32])
            rf = teng.retrieve(index, first, cfg)
            rl = teng.retrieve(index, last, cfg)
            variance[f"b{b}"] = {
                "elements": 2 * b * ENGINE["n_q"] * enc_cfg.out_proj,
                "differing_first": _differing(first, e32[:b]),
                "differing_last": _differing(last, e32[32 - b:]),
                "ids_differ": not (
                    torch.equal(rf.doc_ids, r32.doc_ids[:b]) and
                    torch.equal(rl.doc_ids, r32.doc_ids[32 - b:]))}
    emit("encoder_variance", **variance)

    # 8. profile
    batch = {k: v.to(dev) for k, v in make_batch(0).items()}
    prof = encoder_profile(encoder, qtok, qv, batch)
    emit("encoder_profile", **prof)
    emit("encoder_done", seconds=time.perf_counter() - t_phase)
    return {"launches": launches}


# --- 3c. recsys: the recommender and graph families on the card -------------

# MIND x EMVB: the example's EngineConfig (examples/mind_emvb_retrieval.py),
# an interest a query term, one token an item.
MIND_ENGINE = dict(n_q=4, k=10, nprobe=32, th=0.3, th_r=None, n_filter=4096,
                   n_docs=1024)
# Depths of the recsys phase; widths are the configs' (_recsys_configs).
# MIND trains at batch 4,096, not the train_batch shape's 65,536, whose
# in-batch (B, K, B) float32 logits would take 68.7 GB; its item index has
# 2^14 centroids (PLAID's 16 sqrt(N) over 1M items, rounded to a power of
# two). DLRM trains on float32 tables capped at dlrm_row_cap rows a field
# (the full ones are 96 GB); its PQ tables serve at the full vocabularies.
# Learning rates: the Criteo models' Adagrad at 1e-3, since its first steps
# at the optimizer's default 1e-2 move every weight of the 1,024-wide MLPs
# by 1e-2 and spike the loss (to 289 in a CPU rehearsal at these MLP
# widths); the others at 1e-2.
RECSYS = dict(
    seed=22, mind_batch=4096, mind_steps=50, mind_resume=25,
    mind_window=64, mind_centroids=1 << 14, mind_users=32, mind_singles=8,
    steps=10, resume=5, loss_window=5, train_batch=65_536,
    lr=dict(mind=1e-2, dcn=1e-3, dlrm=1e-3, dien=1e-2, gcn=1e-2),
    serve=(512, 262_144), dlrm_row_cap=1 << 21, time_reps=5)
# GCN minibatch_lg: Reddit's 232,965 nodes and 114,615,892 edges (mean
# degree 492) as a synthetic padded neighbour table on the card, degrees
# uniform in [1, max_degree]; 80 % of a node's neighbours in its class.
GCN_GRAPH = dict(max_degree=984, homophily=0.8, seeds=1024,
                 fanouts=(15, 10))


def _recsys_configs() -> dict:
    """The configs the phase runs: each arch's ``make_config()`` (GCN at
    three of its shapes), DLRM's float32 tables capped at dlrm_row_cap
    rows a field for training."""
    from repro_torch.configs import dcn_v2, dien, dlrm_mlperf, gcn_cora, mind
    cap = RECSYS["dlrm_row_cap"]
    dlrm_train = dlrm_mlperf.make_config()
    return {
        "mind": mind.make_config(),
        "dcn": dcn_v2.make_config(),
        "dlrm_pq": dlrm_mlperf.make_config(use_pq_tables=True),
        "dlrm_train": dataclasses.replace(dlrm_train, vocab_sizes=tuple(
            min(v, cap) for v in dlrm_train.vocab_sizes)),
        "dien": dien.make_config(),
        "gcn": {s: gcn_cora.make_config(s) for s in (
            "full_graph_sm", "minibatch_lg", "molecule")},
        "gcn_dims": {s: gcn_cora.SHAPES[s].dims for s in (
            "full_graph_sm", "minibatch_lg", "molecule")}}


def _cuda_gen(dev, seed: int):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    return g


def _tensor_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in [*model.parameters(), *model.buffers()])


def train_resume(make_model, loss, opt, make_batch, steps: int,
                 resume_at: int, keep: bool = False) -> tuple:
    """``steps`` steps of a Trainer from ``make_model()`` (weights from a
    seed: the same every call), logging every step; then a Trainer that
    stops with a checkpoint at ``resume_at`` and a fresh one resumed from
    it, held against the continuous run (losses and parameter bits). The
    loss must fall: the last ``loss_window`` steps' mean below the first's.
    -> (record, the continuous run's model if ``keep``)."""
    import gc
    import tempfile

    import torch
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = make_model()
    dev = next(model.parameters()).device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {"params": sum(p.numel() for p in model.parameters()),
           "bytes": _tensor_bytes(model), "steps": steps,
           "resume_at": resume_at}

    def trainer(init, **kw):
        return Trainer(loss, opt, make_batch,
                       TrainerConfig(log_every=1, **kw), init, device=dev)
    cont = trainer(model)
    del model
    t0 = time.perf_counter()
    log = cont.run(steps)["log"]
    rec["seconds"] = time.perf_counter() - t0
    losses = [m["loss"] for m in log]
    w = RECSYS["loss_window"]
    rec.update(losses=losses, loss_window=w,
               first_window_mean=statistics.fmean(losses[:w]),
               last_window_mean=statistics.fmean(losses[-w:]),
               ms_per_step=statistics.median(m["sec"] for m in log) * 1e3)
    kept = cont.state.params if keep else None
    want = {n: p.detach().cpu() for n, p in
            cont.state.params.named_parameters()}
    del cont
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        trainer(make_model(), ckpt_dir=d, ckpt_every=resume_at).run(
            resume_at)
        gc.collect()
        resumed = trainer(make_model(), ckpt_dir=d, ckpt_every=steps + 1)
        rlog = resumed.run(steps)["log"]
        rec["resume_seconds"] = time.perf_counter() - t0
    if rlog[0]["step"] != resume_at + 1:
        raise AssertionError("the fresh Trainer did not resume")
    differing = sum(_differing(p.detach(), want[n].to(p.device))
                    for n, p in resumed.state.params.named_parameters())
    rlosses = [m["loss"] for m in rlog]
    rec.update(params_differing=differing,
               losses_equal=rlosses == losses[resume_at:],
               bit_equal=differing == 0 and rlosses == losses[resume_at:],
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9)
    del resumed, want
    gc.collect()
    torch.cuda.empty_cache()
    if not rec["last_window_mean"] < rec["first_window_mean"]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not rec["bit_equal"]:
        raise AssertionError(f"resume differs from the continuous run: "
                             f"{differing} parameter elements, losses "
                             f"{rlosses} vs {losses[resume_at:]}")
    return rec, kept


def forward_ms(forward, model, make_batch, cfg) -> dict:
    """CUDA-event median ms of ``forward`` at the serve_p99 and serve_bulk
    batches (RECSYS["serve"]); each output finite."""
    import torch
    out = {}
    with torch.no_grad():
        for b in RECSYS["serve"]:
            batch = make_batch(b)
            y = forward(model, batch, cfg)
            if y.shape != (b,) or not torch.isfinite(y).all():
                raise AssertionError(f"forward at batch {b}: {y.shape}, "
                                     "not finite")
            out[f"b{b}_ms"] = statistics.median(time_samples(
                lambda: forward(model, batch, cfg), n=RECSYS["time_reps"]))
            del batch, y
    return out


def criteo_batches(cfg, dev, batch: int, seed: int):
    """step -> a Criteo-shaped batch on ``dev``: 13 dense N(0, 1) features,
    one uniform index a field, every slot valid, and a label planted by a
    fixed linear rule on the dense features (so the loss can fall)."""
    import torch
    w_true = torch.randn(cfg.n_dense, generator=_cuda_gen(dev, seed),
                         device=dev)
    vocab = torch.tensor(cfg.vocab_sizes, dtype=torch.float64, device=dev)

    def make(step: int):
        g = _cuda_gen(dev, seed * 1_000_003 + step + 1)
        dense = torch.randn((batch, cfg.n_dense), generator=g, device=dev)
        u = torch.rand((batch, cfg.n_sparse, cfg.nnz), generator=g,
                       device=dev, dtype=torch.float64)
        idx = (u * vocab[:, None]).to(torch.int32)
        return {"dense": dense, "sparse_idx": idx,
                "sparse_valid": torch.ones(idx.shape, dtype=torch.bool,
                                           device=dev),
                "labels": (dense @ w_true > 0).to(torch.int32)}
    return make


def dien_batches(cfg, dev, batch: int, seed: int):
    """step -> a DIEN batch on ``dev``: histories of uniform items and
    categories with valid prefixes of 1..seq_len, a target, and a label
    planted on the target's category (its lower half)."""
    import torch

    def make(step: int):
        g = _cuda_gen(dev, seed * 1_000_003 + step + 1)
        shape = (batch, cfg.seq_len)
        lens = torch.randint(1, cfg.seq_len + 1, (batch, 1), generator=g,
                             device=dev)
        cats = torch.randint(0, cfg.vocab_cats, (batch,), generator=g,
                             device=dev)
        return {
            "hist_items": torch.randint(0, cfg.vocab_items, shape,
                                        generator=g, device=dev),
            "hist_cats": torch.randint(0, cfg.vocab_cats, shape,
                                       generator=g, device=dev),
            "hist_valid": torch.arange(cfg.seq_len, device=dev)[None] < lens,
            "target_item": torch.randint(0, cfg.vocab_items, (batch,),
                                         generator=g, device=dev),
            "target_cat": cats,
            "labels": (cats < cfg.vocab_cats // 2).to(torch.int32)}
    return make


def mind_batches(cfg, dev, batch: int, seed: int):
    """step -> MIND users on ``dev`` whose histories lie in a window of
    mind_window neighbouring items around an anchor, the target its
    middle (the example's popularity neighbourhoods)."""
    import torch
    w = RECSYS["mind_window"]

    def make(step: int):
        g = _cuda_gen(dev, seed * 1_000_003 + step + 1)
        anchor = torch.randint(0, cfg.vocab_items - w, (batch, 1),
                               generator=g, device=dev)
        hist = anchor + torch.randint(0, w, (batch, cfg.seq_len),
                                      generator=g, device=dev)
        return {"hist_items": hist.to(torch.int32),
                "hist_valid": torch.ones((batch, cfg.seq_len),
                                         dtype=torch.bool, device=dev),
                "target_item": (anchor[:, 0] + w // 2).to(torch.int32)}
    return make


def class_feats(g, dev, labels, n_cls: int, d_feat: int):
    """Node features N(0, 1) plus half their class's centroid, and a row
    of zeros at index n (the sampler's sentinel) -> (n + 1, d_feat)."""
    import torch
    n = labels.shape[0]
    cent = torch.randn((n_cls, d_feat), generator=g, device=dev)
    feats = torch.zeros((n + 1, d_feat), device=dev)
    feats[:n] = torch.randn((n, d_feat), generator=g, device=dev) \
        + 0.5 * cent[labels]
    return feats


def neighbours(g, dev, owners, labels, n_cls: int):
    """One neighbour per entry of ``owners`` (classes in contiguous blocks
    of ``labels``): in the owner's class with probability
    GCN_GRAPH["homophily"], else any node."""
    import torch
    n = labels.shape[0]
    start = torch.searchsorted(labels, torch.arange(n_cls, device=dev))
    size = torch.bincount(labels, minlength=n_cls)
    c = labels[owners]
    same = start[c] + (torch.rand(owners.shape, generator=g, device=dev)
                       * size[c]).long()
    anyn = torch.randint(0, n, owners.shape, generator=g, device=dev)
    keep = torch.rand(owners.shape, generator=g, device=dev) < \
        GCN_GRAPH["homophily"]
    return torch.where(keep, same, anyn)


def gcn_full_batch(dev, cfg, dims: dict, seed: int, graphs: int = 1):
    """A full-graph batch on ``dev`` at ``dims`` (n_nodes, n_edges), made
    from ``seed``: classes in contiguous blocks and homophilous edges, or
    with ``graphs`` > 1 a block diagonal of that many equal graphs
    (molecule's), each of one class, each edge inside its graph -> step ->
    that batch."""
    import torch
    n, e, k = dims["n_nodes"], dims["n_edges"], cfg.n_classes
    g = _cuda_gen(dev, seed)
    if graphs > 1:
        per = n // graphs
        labels = torch.arange(n, device=dev) // per % k
        base = torch.randint(0, graphs, (e,), generator=g, device=dev) * per
        src = base + torch.randint(0, per, (e,), generator=g, device=dev)
        dst = base + torch.randint(0, per, (e,), generator=g, device=dev)
    else:
        labels = torch.arange(n, device=dev) * k // n
        src = torch.randint(0, n, (e,), generator=g, device=dev)
        dst = neighbours(g, dev, src, labels, k)
    batch = {"feats": class_feats(g, dev, labels, k, cfg.d_feat)[:n],
             "edges": torch.stack([src, dst]).to(torch.int32),
             "edge_mask": torch.ones(e, dtype=torch.bool, device=dev),
             "labels": labels.to(torch.int32)}
    return lambda step: batch


def gcn_sampled_batches(dev, cfg, dims: dict, seed: int):
    """minibatch_lg on ``dev``: a padded neighbour table of dims' n_nodes
    rows (GCN_GRAPH's degrees and homophily, the sentinel n past each
    degree) -> (step -> GCN_GRAPH["seeds"] seeds drawn from the step and
    their sampled blocks' batch, the table's bytes and edge count)."""
    import torch
    from repro_torch.models import sampler
    n, k = dims["n_nodes"], cfg.n_classes
    g = _cuda_gen(dev, seed)
    labels = torch.arange(n, device=dev) * k // n
    feats = class_feats(g, dev, labels, k, cfg.d_feat)
    md = GCN_GRAPH["max_degree"]
    deg = torch.randint(1, md + 1, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    nbr = torch.empty((n, md), dtype=torch.int32, device=dev)
    for s in range(0, n, 1 << 14):                # rows a block at a time
        rows = torch.arange(s, min(s + (1 << 14), n), device=dev)
        own = rows[:, None].expand(-1, md)
        cols = neighbours(g, dev, own, labels, k)
        pad = torch.arange(md, device=dev)[None] >= deg[rows, None]
        nbr[rows] = torch.where(pad, n, cols).to(torch.int32)

    def make(step: int):
        gs = _cuda_gen(dev, seed * 1_000_003 + step + 1)
        seeds = torch.randint(0, n, (GCN_GRAPH["seeds"],), generator=gs,
                              device=dev, dtype=torch.int32)
        hops, blocks = sampler.sample_blocks(gs, seeds, nbr, deg,
                                             list(GCN_GRAPH["fanouts"]))
        batch = {"labels": labels[seeds.long()].to(torch.int32)}
        for i, h in enumerate(hops):
            batch[f"feats{i}"] = feats[h.long()]
        for i, blk in enumerate(blocks):
            batch[f"edges{i}"] = blk["edges"]
            batch[f"edge_mask{i}"] = blk["edge_mask"]
        return batch
    return make, {"table_bytes": nbr.numel() * 4,
                  "edges": int(deg.sum()), "max_degree": md}


def mind_emvb(model, cfg, dev) -> dict:
    """MIND x EMVB: the EMVB index over the trained item table (one token
    an item) built by ``build_index``; mind_users users' 4 interests served
    on both lanes at B = 32 and one at a time (mind_singles), the launch
    counts read around each; each of the six kernels held against its
    plain version (:func:`hold_lanes`), unfused == fused on the same CS
    and LUT; beside exact MaxSim (``score_candidates``, then ``topk``):
    the top-10 overlap and score ratio, and ms per batch."""
    import numpy as np
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.core import index as tindex
    from repro_torch.core.topk import topk
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import mind
    seed, nu, n1 = RECSYS["seed"], RECSYS["mind_users"], \
        RECSYS["mind_singles"]
    with torch.no_grad():
        items = model.item_emb.detach()
        items = items / torch.clamp(torch.linalg.vector_norm(
            items, dim=-1, keepdim=True), min=1e-9)
    n_items = items.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, meta = tindex.build_index(
        seed, items.cpu().numpy()[:, None, :], np.ones(n_items, np.int32),
        n_centroids=RECSYS["mind_centroids"], m=16, nbits=8, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    users = mind_batches(cfg, dev, nu, seed + 1)(0)
    with torch.no_grad():
        q = mind.user_interests(model, users["hist_items"],
                                users["hist_valid"], cfg)
    ecfg = teng.EngineConfig(**MIND_ENGINE, use_kernels=True)
    ucfg = dataclasses.replace(ecfg, fused_prefilter=False,
                               fused_late_interaction=False)
    launches, results = {}, {}
    for lane, c in (("fused", ecfg), ("unfused", ucfg)):
        ops.reset_launches()
        r32 = teng.retrieve(index, q, c)
        torch.cuda.synchronize()
        launches[lane] = {"b32": ops.launch_counts()}
        ops.reset_launches()
        r1 = [teng.retrieve(index, q[i:i + 1], c) for i in range(n1)]
        torch.cuda.synchronize()
        launches[lane]["b1"] = ops.launch_counts()
        for name, kern in KERNELS.items():
            want = (1, n1) if _on_lane(kern, lane) else (0, 0)
            got = (launches[lane]["b32"][name], launches[lane]["b1"][name])
            if got != want:
                raise AssertionError(f"mind_emvb {lane}: {name} launched "
                                     f"{got}, expected {want}")
        ids, sc = r32.doc_ids, r32.scores
        if ids.shape != (nu, MIND_ENGINE["k"]) or not torch.isfinite(
                sc).all() or not (sc[:, :-1] >= sc[:, 1:]).all() or not (
                (ids >= 0) & (ids < n_items)).all():
            raise AssertionError(f"mind_emvb {lane}: malformed results")
        results[lane] = {"b32": r32, "b1": r1[0],
                         "b1_rows_equal_b32": sum(
                             torch.equal(r.doc_ids[0], ids[i])
                             for i, r in enumerate(r1))}
    held, held_u, lanes_equal = hold_lanes(index, ecfg, ucfg, q, results)
    with torch.no_grad():
        exact = mind.score_candidates(q, items)
        exact_top = topk(exact, MIND_ENGINE["k"])[1]
        top = results["fused"]["b32"].doc_ids.long()
        overlap = float(np.mean([len(set(a) & set(b)) / MIND_ENGINE["k"]
                                 for a, b in zip(exact_top.tolist(),
                                                 top.tolist())]))
        ratio = float((torch.gather(exact, 1, top).mean(1) / torch.gather(
            exact, 1, exact_top).mean(1)).mean())
        cand = held["b32"]["bitmap"].sum(1).float()
        ms = {}
        for b, qb in (("b32", q), ("b1", q[:1])):
            for lane, c in (("fused", ecfg), ("unfused", ucfg)):
                ms[f"{lane}_{b}"] = statistics.median(time_samples(
                    lambda: teng.retrieve(index, qb, c),
                    n=RECSYS["time_reps"]))
            ms[f"exact_{b}"] = statistics.median(time_samples(
                lambda: topk(mind.score_candidates(qb, items),
                             MIND_ENGINE["k"]), n=RECSYS["time_reps"]))
    return dict(
        items=n_items, d=items.shape[1], engine=MIND_ENGINE,
        n_centroids=RECSYS["mind_centroids"], m=16, nbits=8,
        build_seconds=build_s, list_cap=meta.list_cap,
        build_max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, phases_exact=True,
        unfused_equals_fused=lanes_equal,
        b1_rows_equal_b32={lane: r["b1_rows_equal_b32"]
                           for lane, r in results.items()},
        candidates_per_query={"mean": float(cand.mean()),
                              "min": int(cand.min()), "max": int(cand.max())},
        docs_some_query_candidate=int(held["b32"]["bitmap"].any(0).sum()),
        top10_overlap_with_exact=overlap, score_ratio_to_exact=ratio,
        ms_per_batch=ms,
        max_abs_err={b: {**held[b]["err"], **held_u[b]["err"]}
                     for b in ("b32", "b1")})


def recsys_phase(dev) -> dict:
    """Phase 3c: the recommender and graph families through the port on
    the card, run while nothing else is resident, each model freed before
    the next. MIND (config widths) trained, resumed and served through
    EMVB (:func:`mind_emvb`); DCN-v2 at the full Criteo-1TB vocabularies
    trained with Adagrad and timed forward at serve_p99 and serve_bulk;
    DLRM with PQ tables at the full vocabularies timed forward, and
    trained on capped float32 tables; DIEN at its full config; GCN at
    minibatch_lg (the sampler on the card), full_graph_sm and molecule.
    Every training: the loss falls and a resumed run equals the continuous
    one bit for bit. -> the MIND x EMVB launch counts."""
    import gc

    import torch
    from repro_torch.models import gcn
    from repro_torch.models.recsys import dcn, dien, dlrm, mind
    from repro_torch.train import optimizer
    t_phase = time.perf_counter()
    cfgs = _recsys_configs()
    seed, steps, res = RECSYS["seed"], RECSYS["steps"], RECSYS["resume"]
    tb, lr = RECSYS["train_batch"], RECSYS["lr"]

    def done():
        gc.collect()
        torch.cuda.empty_cache()

    def loss_of(mod, cfg, name="loss_fn"):
        fn = getattr(mod, name)
        return lambda p, b: fn(p, b, cfg)

    # MIND, then its items through EMVB
    cfg = cfgs["mind"]
    rec, model = train_resume(
        lambda: mind.init_params(seed, cfg, dev), loss_of(mind, cfg),
        optimizer.make("adamw", lr=lr["mind"]),
        mind_batches(cfg, dev, RECSYS["mind_batch"], seed),
        RECSYS["mind_steps"], RECSYS["mind_resume"], keep=True)
    emit("recsys_mind_train", config=_cfg_record(cfg),
         batch=RECSYS["mind_batch"], optimizer="adamw", lr=lr["mind"],
         **rec)
    mrec = mind_emvb(model, cfg, dev)
    emit("recsys_mind_emvb", **mrec)
    del model
    done()

    # DCN-v2 at the full vocabularies
    cfg = cfgs["dcn"]
    rec, _ = train_resume(
        lambda: dcn.init_params(seed, cfg, dev), loss_of(dcn, cfg),
        optimizer.make("adagrad", lr=lr["dcn"]),
        criteo_batches(cfg, dev, tb, seed), steps, res)
    done()
    model = dcn.init_params(seed, cfg, dev)
    fwd = forward_ms(dcn.forward, model, lambda b: criteo_batches(
        cfg, dev, b, seed + 1)(0), cfg)
    del model
    done()
    emit("recsys_dcn", config=_cfg_record(cfg), batch=tb,
         optimizer="adagrad", lr=lr["dcn"], forward=fwd, **rec)

    # DLRM: PQ tables at the full vocabularies (forward), capped float32
    # tables (training)
    cfg = cfgs["dlrm_pq"]
    torch.cuda.reset_peak_memory_stats()
    model = dlrm.init_params(seed, cfg, dev)
    pq = {"params": sum(p.numel() for p in model.parameters()),
          "bytes": _tensor_bytes(model),
          "rows": sum(cfg.vocab_sizes),
          "forward": forward_ms(dlrm.forward, model, lambda b: criteo_batches(
              cfg, dev, b, seed + 1)(0), cfg),
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model
    done()
    cfg = cfgs["dlrm_train"]
    rec, _ = train_resume(
        lambda: dlrm.init_params(seed, cfg, dev), loss_of(dlrm, cfg),
        optimizer.make("adagrad", lr=lr["dlrm"]),
        criteo_batches(cfg, dev, tb, seed), steps, res)
    done()
    emit("recsys_dlrm", pq_tables=pq, train_config=_cfg_record(cfg),
         train_rows=sum(cfg.vocab_sizes), batch=tb, optimizer="adagrad",
         lr=lr["dlrm"], **rec)

    # DIEN
    cfg = cfgs["dien"]
    rec, _ = train_resume(
        lambda: dien.init_params(seed, cfg, dev), loss_of(dien, cfg),
        optimizer.make("adagrad", lr=lr["dien"]),
        dien_batches(cfg, dev, tb, seed), steps, res)
    done()
    model = dien.init_params(seed, cfg, dev)
    fwd = forward_ms(dien.forward, model, lambda b: dien_batches(
        cfg, dev, b, seed + 1)(0), cfg)
    del model
    done()
    emit("recsys_dien", config=_cfg_record(cfg), batch=tb,
         optimizer="adagrad", lr=lr["dien"], forward=fwd, **rec)

    # GCN at three shapes
    gcn_rec = {}
    for shape, cfg in cfgs["gcn"].items():
        dims = cfgs["gcn_dims"][shape]
        extra = {}
        if shape == "minibatch_lg":
            make_batch, extra = gcn_sampled_batches(dev, cfg, dims, seed)
            loss = loss_of(gcn, cfg, "loss_fn_sampled")
        else:
            make_batch = gcn_full_batch(
                dev, cfg, dims, seed, graphs=128 if shape == "molecule"
                else 1)
            loss = loss_of(gcn, cfg)
        rec, _ = train_resume(
            lambda: gcn.init_params(seed, cfg, dev), loss,
            optimizer.make("adamw", lr=lr["gcn"]), make_batch, steps,
            res)
        gcn_rec[shape] = {"config": _cfg_record(cfg), "dims": dims,
                          **extra, **rec}
        del make_batch
        done()
    emit("recsys_gcn", optimizer="adamw", lr=lr["gcn"],
         graph=GCN_GRAPH, **gcn_rec)
    emit("recsys_done", seconds=time.perf_counter() - t_phase)
    return {"launches": mrec["launches"]}


def _cfg_record(cfg) -> dict:
    """A config as JSON: its fields, the dtype by name."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(d["dtype"]).split(".")[-1]
    return d


# --- 3d. lm --------------------------------------------------------------------

# The LM serving path at granite-moe-1b-a400m's full config
# (src/repro/configs/granite_moe_1b.py) and the lengths of the LM shapes
# prefill_32k and decode_32k (configs/registry.py::lm_shapes), their batches
# cut: 32 sequences' cache alone would be 51.5 GB beside their 21 GB (E, C, d)
# dispatch, and 128 sequences' cache 206 GB.
LM = dict(
    arch="granite-moe-1b-a400m", seed=23,
    prefill_batch=2, prefill_seq=32_768,
    decode_steps=32, cache_seq=32_800,
    decode_batch=32, decode_seq=32_768, decode_reps=10, route_reps=4,
    # dense consistency: qwen2.5-3b's widths, 4 of its 36 layers, float32
    dense_arch="qwen2.5-3b", dense_layers=4, dense_seq=8192, dense_steps=16,
    dense_rtol=1e-4,
    # card against CPU: the smoke configs with the chunked path forced
    smoke_archs=("granite-moe-1b-a400m", "kimi-k2-1t-a32b"), smoke_batch=2,
    smoke_prompt=32, smoke_steps=4, smoke_rtol=1e-5,
    smoke_chunks=dict(attn_q_chunk=8, attn_kv_chunk=16,
                      attn_chunk_min_seq=16),
    train_steps=20, train_resume=10, loss_window=5)
# H100 SXM data-sheet peak (no measurement): bf16 on the tensor cores, dense.
BF16_OPS_PER_S = 989e12


def _lm_configs() -> dict:
    """The phase's configs: granite at its full config, qwen2.5-3b's widths
    at dense_layers layers in float32, and the two smoke configs with
    experts, the chunked path forced."""
    import torch
    from repro_torch.configs import registry
    return {
        "full": registry.get(LM["arch"]).make_config(),
        "dense": dataclasses.replace(
            registry.get(LM["dense_arch"]).make_config(dtype=torch.float32),
            n_layers=LM["dense_layers"]),
        "smoke": {a: dataclasses.replace(registry.get(a).make_smoke_config(),
                                         **LM["smoke_chunks"])
                  for a in LM["smoke_archs"]}}


class RouteLog:
    """While open, wraps ``repro_torch.models.moe.route``: counts the
    token-expert assignments routed and those the capacity gather drops
    (an expert takes its top-C tokens by gate, so sum over experts of
    max(routed - C, 0)), on the device without a sync; with ``keep``, every
    call's expert ids on the host as well."""

    def __init__(self, cfg, keep: bool = False):
        self.cfg, self.keep = cfg, keep
        self.routed, self.dropped, self.ids = 0, [], []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route

        def route(router, x, k):
            probs, topv, topi = self._route(router, x, k)
            ids = topi.reshape(-1, k)
            t = ids.shape[0]
            counts = torch.zeros(self.cfg.n_experts, dtype=torch.int64,
                                 device=ids.device).scatter_add_(
                0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))
            cap = moe.gather_capacity(t, self.cfg)
            self.routed += t * k
            self.dropped.append(torch.clamp(counts - cap, min=0).sum())
            if self.keep:
                self.ids.append(ids.cpu())
            return probs, topv, topi
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def record(self) -> dict:
        dropped = int(sum(int(d) for d in self.dropped))
        return {"assignments": self.routed, "dropped": dropped,
                "dropped_share": dropped / max(self.routed, 1)}


def _same_bits(a, b) -> bool:
    """Two tensors of one dtype hold the same bits."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    it = ints[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(it), b.contiguous().view(it))


def _scaled_err(got, want) -> dict:
    """max |got - want|, beside max |want|, in float32."""
    import torch
    d = (got.float() - want.float()).abs().max()
    return {"max_abs_err": float(d),
            "max_abs_want": float(want.float().abs().max())}


def _hold(got, want, rtol: float, what: str) -> dict:
    """Raises unless got == want at rtol, with an atol of rtol times the
    largest |want| (an element near zero carries the rounding of the large
    terms it is a difference of)."""
    import torch
    err = _scaled_err(got, want)
    atol = rtol * err["max_abs_want"]
    if not torch.allclose(got.float().cpu(), want.float().cpu(), rtol=rtol,
                          atol=atol):
        raise AssertionError(f"{what}: {err} beyond rtol {rtol}")
    return err


def lm_prefill_flops(cfg, b: int, s: int, cap: int) -> int:
    """Operations of a prefill of b sequences of s tokens as the port runs
    it: the attention's weight products, QK^T and PV over the causal half,
    the router, the experts' three products over the E·C rows the capacity
    gather runs (padding rows included), and the head at the last
    position."""
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    t = b * s
    proj = 2 * t * d * (2 * h * dh + 2 * kv * dh)
    attn = 4 * b * h * dh * (s * (s + 1) // 2)
    ffn = 2 * t * d * e + 6 * e * cap * d * f
    return cfg.n_layers * (proj + attn + ffn) + 2 * b * d * cfg.vocab


def lm_decode_bytes(model, cfg, b: int, s_cache: int) -> int:
    """Bytes a decode step must read: the whole cache (attention runs over
    every position, the future ones masked) and every weight but the
    embedding table, of which b rows."""
    el = model.embed.element_size()
    cache = 2 * cfg.n_layers * b * s_cache * cfg.n_kv_heads * cfg.d_head * el
    weights = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if n != "embed")
    return cache + weights + b * cfg.d_model * el


def _event_ms(fn) -> tuple:
    """(ms on CUDA events, fn's result)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def _padded_cache(cache, s_max: int):
    """A copy of a prefill's cache in a zero cache of s_max positions."""
    import torch
    from repro_torch.models.transformer import KVCache
    shape = list(cache.k.shape)
    shape[2] = s_max
    out = KVCache(torch.zeros(shape, dtype=cache.k.dtype,
                              device=cache.k.device),
                  torch.zeros(shape, dtype=cache.v.dtype,
                              device=cache.v.device))
    s = cache.k.shape[2]
    out.k[:, :, :s] = cache.k
    out.v[:, :, :s] = cache.v
    return out


def _greedy(model, cfg, cache, logits, pos: int, steps: int) -> tuple:
    """``steps`` greedy decode steps from ``logits`` at ``pos`` into
    ``cache`` in place -> (per-step event ms, logits of each step)."""
    from repro_torch.models import transformer
    ms, outs = [], []
    for i in range(steps):
        tok = logits.argmax(-1)
        t, logits = _event_ms(lambda: transformer.decode_step(
            model, cache, tok, pos + i, cfg)[0])
        ms.append(t)
        outs.append(logits)
    return ms, outs


def lm_full_width(dev, smi: str) -> dict:
    """(a) and (b): granite-moe-1b-a400m at its full config, weights from a
    seed; prefill at B x S, twice (the second timed; both bit-equal), its
    cache padded, LM["decode_steps"] greedy decode steps, twice (the first
    timed; bit-equal), then decode at decode_32k's length over a cache
    filled from a seed. Each time beside its bound; the share of
    assignments the capacity gather drops."""
    import gc

    import torch
    from repro_torch.models import moe, transformer
    cfg = _lm_configs()["full"]
    t0 = time.perf_counter()
    model = transformer.init_params(LM["seed"], cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    b, s = LM["prefill_batch"], LM["prefill_seq"]
    g = torch.Generator(device=dev)
    g.manual_seed(LM["seed"])
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()

    with RouteLog(cfg) as route_pf:
        t0 = time.perf_counter()
        logits1, cache1 = transformer.prefill(model, tokens, cfg)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    pf_ms, (logits2, cache2) = _event_ms(
        lambda: transformer.prefill(model, tokens, cfg))
    prefill_equal = (_same_bits(logits1, logits2)
                     and _same_bits(cache1.k, cache2.k)
                     and _same_bits(cache1.v, cache2.v))
    del logits2
    cap = moe.gather_capacity(b * s, cfg)
    flops = lm_prefill_flops(cfg, b, s, cap)
    prefill = {
        "batch": b, "seq": s, "chunked": True, "capacity": cap,
        "cold_seconds": cold_s, "ms": pf_ms,
        "tokens_per_s": b * s / (pf_ms / 1e3), "flops": flops,
        "tflops_per_s": flops / (pf_ms / 1e3) / 1e12,
        "share_of_bf16_dense_peak": flops / (pf_ms / 1e3) / BF16_OPS_PER_S,
        "routing": route_pf.record()}
    if not torch.isfinite(logits1.float()).all():
        raise AssertionError("prefill logits not finite")

    # greedy decode at B = prefill_batch, twice from the same cache
    caches = [_padded_cache(c, LM["cache_seq"]) for c in (cache1, cache2)]
    del cache1, cache2
    gc.collect()
    steps = LM["decode_steps"]
    ms, outs = _greedy(model, cfg, caches[0], logits1, s, steps)
    with RouteLog(cfg) as route_d2:
        _, outs2 = _greedy(model, cfg, caches[1], logits1, s, steps)
    decode_equal = (all(_same_bits(x, y) for x, y in zip(outs, outs2))
                    and _same_bits(caches[0].k, caches[1].k)
                    and _same_bits(caches[0].v, caches[1].v))
    if not all(torch.isfinite(x.float()).all() for x in outs):
        raise AssertionError("decode logits not finite")
    bytes_b2 = lm_decode_bytes(model, cfg, b, LM["cache_seq"])
    decode_b2 = {
        "batch": b, "cache_seq": LM["cache_seq"], "steps": steps,
        "ms_per_step": ms, "median_ms": statistics.median(ms),
        "bound_bytes": bytes_b2, "bound_ms": bytes_b2 / HBM_BYTES_PER_S * 1e3,
        "tokens": [int(x.argmax(-1)[0]) for x in outs][:8],
        "routing": route_d2.record()}
    peak_prefill = torch.cuda.max_memory_allocated() / 1e9
    del caches, outs, outs2, logits1
    gc.collect()
    torch.cuda.empty_cache()

    # decode at decode_32k's length over a cache filled from a seed
    bd, sd = LM["decode_batch"], LM["decode_seq"]
    torch.cuda.reset_peak_memory_stats()
    cache = transformer.init_cache(cfg, bd, sd, dev)
    for t in (cache.k, cache.v):
        for i in range(cfg.n_layers):
            t[i].normal_(generator=g)
    tok = torch.randint(0, cfg.vocab, (bd,), generator=g, device=dev)
    pos = sd - 1

    def step():
        return transformer.decode_step(model, cache, tok, pos, cfg)[0]
    times = time_samples(step, n=LM["decode_reps"], warmup=2)
    with RouteLog(cfg) as route_d32:
        for _ in range(LM["route_reps"]):
            out = step()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("decode_32k logits not finite")
    bytes_b32 = lm_decode_bytes(model, cfg, bd, sd)
    decode_b32 = {
        "batch": bd, "cache_seq": sd, "pos": pos,
        "cache_gb": (cache.k.numel() + cache.v.numel())
        * cache.k.element_size() / 1e9,
        "ms_per_step": times, "median_ms": statistics.median(times),
        "bound_bytes": bytes_b32, "bound_ms": bytes_b32 / HBM_BYTES_PER_S * 1e3,
        "routing": route_d32.record(),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    decode_b2["share_of_bound"] = decode_b2["bound_ms"] / decode_b2["median_ms"]
    decode_b32["share_of_bound"] = (decode_b32["bound_ms"]
                                    / decode_b32["median_ms"])
    del cache, model
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"card": smi, "config": _cfg_record(cfg), "params": n_params,
           "weight_bytes": w_bytes, "init_seconds": init_s,
           "prefill": prefill, "decode_b2": decode_b2,
           "decode_b32": decode_b32,
           "max_memory_allocated_gb_prefill_decode_b2": peak_prefill}
    det = {"card": smi, "prefill_bit_equal": prefill_equal,
           "decode_steps_bit_equal": decode_equal, "decode_steps": steps}
    if not (prefill_equal and decode_equal):
        raise AssertionError(f"granite prefill/decode not deterministic: {det}")
    return rec, det


def lm_dense_consistency(dev, smi: str) -> dict:
    """(c): qwen2.5-3b at its full widths, LM["dense_layers"] layers,
    float32: prefill over dense_seq tokens (the chunked path), then
    dense_steps decode steps fed the next tokens; each step's logits (and
    the prefill's) equal ``forward``'s at that position over the same
    tokens at dense_rtol, with the same argmax."""
    import gc

    import torch
    from repro_torch.core.precision import exact_matmuls
    from repro_torch.models import layers, transformer
    cfg = _lm_configs()["dense"]
    s, n = LM["dense_seq"], LM["dense_steps"]
    model = transformer.init_params(LM["seed"], cfg, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(LM["seed"] + 1)
    tokens = torch.randint(0, cfg.vocab, (1, s + n), generator=g, device=dev)
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(model, tokens[:, :s], cfg)
    cache = _padded_cache(cache, s + n)
    got = [logits]
    for i in range(n):
        got.append(transformer.decode_step(model, cache, tokens[:, s + i],
                                           s + i, cfg)[0])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    del cache
    with torch.no_grad(), exact_matmuls():
        want, _ = transformer.forward(model, tokens, cfg, remat=False)
    errs, argmax_equal = [], True
    for i, x in enumerate(got):
        w = want[:, s - 1 + i]
        errs.append(_hold(x, w, LM["dense_rtol"], f"dense decode {i}"))
        argmax_equal &= bool(torch.equal(x.argmax(-1), w.argmax(-1)))
    del want, model
    gc.collect()
    torch.cuda.empty_cache()
    if not argmax_equal:
        raise AssertionError("dense decode argmax differs from forward's")
    return {"card": smi, "config": _cfg_record(cfg),
            "prefill_chunked": layers.uses_chunked(cfg, s),
            "forward_chunked": layers.uses_chunked(cfg, s + n),
            "seq": s, "steps": n, "rtol": LM["dense_rtol"],
            "atol": "rtol x max |forward logits|",
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "max_abs_logit": max(e["max_abs_want"] for e in errs),
            "argmax_equal": argmax_equal, "serve_seconds": serve_s}


def lm_card_vs_cpu(dev, smi: str) -> dict:
    """(d): the granite and kimi smoke configs (float32, chunked path
    forced) from one seed on the card and on the CPU: the prefill and
    LM["smoke_steps"] decode steps fed the CPU's greedy tokens give the
    same logits and caches at smoke_rtol and the same routed expert ids;
    on the card, the grouped dispatch equals the capacity gather at ample
    capacity."""
    import torch
    from repro_torch.models import moe, transformer
    out = {"card": smi, "rtol": LM["smoke_rtol"]}
    for arch, cfg in _lm_configs()["smoke"].items():
        b, s = LM["smoke_batch"], LM["smoke_prompt"]
        tokens = torch.randint(0, cfg.vocab, (b, s),
                               generator=torch.Generator().manual_seed(5))
        runs = {}
        for where in ("cpu", dev):
            model = transformer.init_params(LM["seed"], cfg, where)
            with RouteLog(cfg, keep=True) as log:
                logits, cache = transformer.prefill(model, tokens.to(where),
                                                    cfg)
                cache = _padded_cache(cache, s + LM["smoke_steps"])
                seq = [logits]
                for i in range(LM["smoke_steps"]):
                    nxt = (runs["cpu"]["logits"][i].argmax(-1) if runs
                           else logits.argmax(-1))
                    logits = transformer.decode_step(
                        model, cache, nxt.to(where), s + i, cfg)[0]
                    seq.append(logits)
            runs[str(where)] = {"logits": [x.cpu() for x in seq],
                                "k": cache.k.cpu(), "v": cache.v.cpu(),
                                "ids": log.ids, "model": model}
        cpu, card = runs["cpu"], runs[str(dev)]
        errs = [_hold(x, y, LM["smoke_rtol"], f"{arch} step {i}")
                for i, (x, y) in enumerate(zip(card["logits"],
                                               cpu["logits"]))]
        errs += [_hold(card[k], cpu[k], LM["smoke_rtol"], f"{arch} cache {k}")
                 for k in ("k", "v")]
        ids_equal = len(card["ids"]) == len(cpu["ids"]) and all(
            torch.equal(x, y) for x, y in zip(card["ids"], cpu["ids"]))
        if not ids_equal:
            raise AssertionError(f"{arch}: routed expert ids differ")
        ample = dataclasses.replace(cfg, capacity_factor=100.0)
        x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator(
            ).manual_seed(6)).to(dev)
        block = card["model"].layers[0].moe
        with torch.no_grad():
            base, aux = moe.moe_block(block, x, ample)
            grouped = {}
            for groups in (1, 2, 4):
                og, ag = moe.moe_block(
                    block, x, dataclasses.replace(ample, moe_groups=groups))
                grouped[groups] = _hold(og, base, LM["smoke_rtol"],
                                        f"{arch} grouped {groups}")
                _hold(ag, aux, LM["smoke_rtol"], f"{arch} aux {groups}")
        out[arch] = {"config": _cfg_record(cfg), "prompt": s,
                     "steps": LM["smoke_steps"],
                     "max_abs_err": max(e["max_abs_err"] for e in errs),
                     "route_calls": len(card["ids"]),
                     "routed_ids_equal": ids_equal,
                     "grouped_vs_gather_max_abs_err": max(
                         e["max_abs_err"] for e in grouped.values())}
    return out


def lm_train(dev, smi: str) -> dict:
    """(e): the granite and kimi smoke configs, LM["train_steps"] steps
    each through ``launch.train.build_smoke_trainer``: the loss falls (the
    last loss_window steps' mean below the first's), and a fresh trainer
    resumed from the checkpoint at train_resume equals the continuous run
    bit for bit (losses and parameters)."""
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.launch.train import build_smoke_trainer
    steps, at, w = LM["train_steps"], LM["train_resume"], LM["loss_window"]
    out = {"card": smi}

    def trainer(arch, **kw):
        tr = build_smoke_trainer(arch, device=dev, **kw)
        tr.cfg = dataclasses.replace(tr.cfg, log_every=1)
        return tr
    for arch in LM["smoke_archs"]:
        cont = trainer(arch)
        t0 = time.perf_counter()
        log = cont.run(steps)["log"]
        secs = time.perf_counter() - t0
        losses = [m["loss"] for m in log]
        want = {n: p.detach().clone()
                for n, p in cont.state.params.named_parameters()}
        with tempfile.TemporaryDirectory() as d:
            trainer(arch, ckpt_dir=d, steps_per_ckpt=at).run(at)
            resumed = trainer(arch, ckpt_dir=d, steps_per_ckpt=steps + 1)
            rlog = resumed.run(steps)["log"]
        if rlog[0]["step"] != at + 1:
            raise AssertionError(f"{arch}: the fresh trainer did not resume")
        differing = sum(int(not _same_bits(p.detach(), want[n]))
                        for n, p in resumed.state.params.named_parameters())
        rlosses = [m["loss"] for m in rlog]
        first, last = statistics.fmean(losses[:w]), statistics.fmean(
            losses[-w:])
        rec = {"optimizer": registry.get(arch).optimizer, "losses": losses,
               "first_window_mean": first, "last_window_mean": last,
               "seconds": secs, "params_differing": differing,
               "bit_equal": differing == 0 and rlosses == losses[at:]}
        out[arch] = rec
        if not last < first:
            raise AssertionError(f"{arch}: the loss did not fall: {losses}")
        if not rec["bit_equal"]:
            raise AssertionError(f"{arch}: resume differs: {differing} "
                                 f"tensors, {rlosses} vs {losses[at:]}")
    return out


def lm_phase(dev) -> dict:
    """Phase 3d: the LM serving path on the card, run while nothing else is
    resident: (a) granite-moe-1b-a400m at full width, prefill and decode
    timed beside their bounds, with the share of assignments dropped by
    capacity; (b) its prefill and decode run twice, bit-equal; (c) decode
    == forward on qwen2.5-3b's widths, float32; (d) the smoke configs with
    experts on the card == on the CPU, grouped == gather at ample
    capacity; (e) their smoke trainers' losses fall and resume bit-equal.
    No hand-written kernel runs on this path: the launch counts read
    around the phase are all 0. -> those counts."""
    import torch
    from repro_torch.kernels import ops
    smi = RECORD["device"]["nvidia_smi"]
    t_phase = time.perf_counter()
    ops.reset_launches()
    full, det = lm_full_width(dev, smi)
    emit("lm_granite", **full)
    emit("lm_determinism", **det)
    emit("lm_dense_consistency", **lm_dense_consistency(dev, smi))
    emit("lm_card_vs_cpu", **lm_card_vs_cpu(dev, smi))
    emit("lm_train", **lm_train(dev, smi))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    emit("lm_done", card=smi, seconds=time.perf_counter() - t_phase,
         kernel_launches=launches)
    return {"launches": launches}



# --- 3e. dryrun: every cell reckoned a chip; the cells of one card run ------

DRYRUN_SEED = 31
TRAIN_PEAK_CAP = 60e9   # the cut train_4k cell's reckoned peak, at most
TRAIN_SEQ = 4096        # ... at batch >= 1 of these
DRYRUN_REPS = 3         # timed calls of a cell after its first


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree of real tensors."""
    from repro_torch.launch.op_stats import tensors
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors(tree)}.values())


def _same_leaves(cell, args) -> None:
    """Raises unless the real arguments have the meta cell's leaves, shapes
    and dtypes."""
    from repro_torch.launch import steps
    want = {p: (tuple(t.shape), t.dtype)
            for p, t in steps.leaves(cell.args).items()}
    got = {p: (tuple(t.shape), t.dtype)
           for p, t in steps.leaves(args).items()}
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()), key=str)[:4]
        raise AssertionError(f"{cell.spec.name} {cell.shape}: the real "
                             f"arguments differ from the cell's: {bad}")


def hold_cell(cell, make, reps: int = DRYRUN_REPS) -> dict:
    """One cell on the card against its reckoning on the 1 x 1 mesh:
    argument bytes (reckoned == the storages the arguments hold, exactly),
    FLOPs counted on the card beside those counted on meta, the reckoned
    temporaries and peak beside ``max_memory_allocated`` above what was
    resident before the call, and the median of ``reps`` timed calls beside
    the roofline bound. ``make()`` gives the call's arguments: the same
    ones, or fresh ones where a call consumes them (a train step); no two
    sets are alive at once."""
    import torch
    from repro_torch.launch import op_stats
    args = make()
    _same_leaves(cell, args)
    meta = op_stats.global_counts(cell)
    rec = op_stats.reckon(cell, meta)
    alloc = _storage_bytes(args)
    if alloc != rec["argument_bytes_per_chip"]:
        raise AssertionError(f"{cell.spec.name} {cell.shape}: reckoned "
                             f"argument bytes {rec['argument_bytes_per_chip']}"
                             f" != {alloc} allocated")
    del args
    card = op_stats.count(cell.fn, make())
    ms, temps = [], []
    for _ in range(reps):
        a = make()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t, out = _event_ms(lambda: cell.fn(*a))
        ms.append(t)
        temps.append(torch.cuda.max_memory_allocated() - base)
        del a, out
    temp = max(temps)
    ms_med = statistics.median(ms)
    return {
        "argument_bytes_reckoned": rec["argument_bytes_per_chip"],
        "argument_bytes_allocated": alloc,
        "flops_card": card["flops"], "flops_meta": meta["flops"],
        "flops_equal": card["flops"] == meta["flops"],
        "temp_bytes_reckoned": rec["temp_bytes_per_chip"],
        "temp_bytes_measured": temp,
        "peak_bytes_reckoned": rec["peak_bytes_per_chip"],
        "peak_bytes_measured": alloc + temp,
        "peak_ratio": rec["peak_bytes_per_chip"] / (alloc + temp),
        "ms": ms_med, "ms_all": ms, "bound_ms": rec["bound_s"] * 1e3,
        "bound_by": rec["dominant"],
        "ms_over_bound": ms_med / (rec["bound_s"] * 1e3),
        "bytes_reckoned": rec["bytes_per_chip"],
        "fits_80gb": rec["fits"], "card": RECORD["device"]["nvidia_smi"]}


def _lm_fill(model, gen) -> None:
    """Random weights on the card from ``gen``: norm scales 1, every other
    parameter N(0, 0.02²)."""
    import torch
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.fill_(1)
            else:
                p.normal_(0.0, 0.02, generator=gen)


def _train_cut(spec, mesh) -> tuple:
    """(the largest train_4k batch of TRAIN_SEQ tokens whose reckoned peak
    on one card is under TRAIN_PEAK_CAP, never below 1, its cut cell, and
    the peaks reckoned on the way): a bisection over the batch, the peak
    growing with it."""
    from repro_torch.launch import op_stats, steps
    peaks, cells = {}, {}

    def fits(b: int) -> bool:
        shape = dataclasses.replace(spec.shapes["train_4k"],
                                    dims={"seq": TRAIN_SEQ, "batch": b})
        cells[b] = steps.build_cell(dataclasses.replace(
            spec, shapes={**spec.shapes, "train_4k": shape}), "train_4k",
            mesh)
        peaks[b] = op_stats.reckon(cells[b])["peak_bytes_per_chip"]
        return peaks[b] < TRAIN_PEAK_CAP
    lo, hi = 1, spec.shapes["train_4k"].dims["batch"]
    fits(lo)
    if fits(hi):
        lo = hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo, cells[lo], peaks


def dryrun_card_cells(dev, smi: str) -> dict:
    """The dry run's cells that fit one card, on the 1 x 1 mesh with real
    tensors at full width (before the planted index loads): granite's
    long_500k decode, dcn-v2's serve_p99 at the Criteo-1TB vocabularies,
    gcn-cora's full_graph_sm train step, and granite's train_4k cut to the
    batch of TRAIN_PEAK_CAP, two steps run twice, bit-equal."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import op_stats, steps
    from repro_torch.launch.mesh import single_card_mesh
    from repro_torch.models import gcn, to_reference_layout
    from repro_torch.models import transformer as T
    from repro_torch.models.recsys import dcn
    from repro_torch.train.trainer import TrainState
    mesh = single_card_mesh()
    gen = _cuda_gen(dev, DRYRUN_SEED)
    out = {}

    # granite long_500k: one decode step at batch 1 over 524,288 positions
    cell = steps.build_cell("granite-moe-1b-a400m", "long_500k", mesh)
    params, cache_m, tok_m, _ = cell.args
    params = params.to_empty(device=dev)
    _lm_fill(params, gen)
    cache = T.KVCache(*(torch.randn(t.shape, generator=gen, device=dev,
                                    dtype=t.dtype) for t in cache_m))
    token = torch.randint(0, cell.cfg.vocab, tok_m.shape, generator=gen,
                          device=dev, dtype=torch.int32)
    pos = torch.tensor(cell.dims["seq"] - 1, dtype=torch.int32, device=dev)
    rec = hold_cell(cell, lambda: (params, cache, token, pos))
    rec["cache_gb"] = sum(t.numel() * t.element_size() for t in cache) / 1e9
    out["granite_long_500k"] = rec
    emit("dryrun_granite_long_500k", **rec)
    del cache, token, pos
    lm_params = params

    # dcn-v2 serve_p99 at the full vocabularies
    cell = steps.build_cell("dcn-v2", "serve_p99", mesh)
    model = dcn.init_params(DRYRUN_SEED, cell.cfg, dev)
    batch = criteo_batches(cell.cfg, dev, cell.dims["batch"],
                           DRYRUN_SEED)(0)
    batch.pop("labels")
    out["dcn_serve_p99"] = hold_cell(cell, lambda: (model, batch))
    emit("dryrun_dcn_serve_p99", **out["dcn_serve_p99"])
    del model, batch

    # gcn-cora full_graph_sm: one AdamW step on Cora's sizes
    cell = steps.build_cell("gcn-cora", "full_graph_sm", mesh)
    opt = steps._optimizer_for(cell.spec)
    # each tensor its own storage (the generator's feats are a view)
    batch = {k: v.clone() for k, v in gcn_full_batch(
        dev, cell.cfg, cell.dims, DRYRUN_SEED)(0).items()}

    def gcn_args():
        m = gcn.init_params(DRYRUN_SEED, cell.cfg, dev)
        return (TrainState(torch.zeros((), dtype=torch.int32, device=dev), m,
                           opt.init(to_reference_layout(m))), batch)
    out["gcn_full_graph_sm"] = hold_cell(cell, gcn_args)
    emit("dryrun_gcn_full_graph_sm", **out["gcn_full_graph_sm"])
    del batch
    torch.cuda.empty_cache()

    # granite train_4k, cut to the largest batch under TRAIN_PEAK_CAP; its
    # steps free and take back blocks of many sizes, which fragment the
    # caching allocator's fixed segments (22 GiB reserved but unallocated
    # at an out-of-memory on the card), so its blocks come from expandable
    # segments, for this cell only
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        out["granite_train_4k_cut"] = _train_cell(dev, mesh, lm_params)
    finally:
        del lm_params
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    for name, r in out.items():
        if not r["flops_equal"]:
            raise AssertionError(f"{name}: FLOPs counted on the card "
                                 f"{r['flops_card']} != on meta "
                                 f"{r['flops_meta']}")
    return out


def _train_cell(dev, mesh, lm_params) -> dict:
    """granite's train_4k cell cut by :func:`_train_cut`, held as
    :func:`hold_cell` holds a cell, then two steps run twice from the same
    weights and state, bit-equal; the weights are ``lm_params``'s."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import to_reference_layout
    from repro_torch.train.trainer import TrainState
    spec = registry.get("granite-moe-1b-a400m")
    b, cell, peaks = _train_cut(spec, mesh)
    opt = steps._optimizer_for(cell.spec)
    # the starting weights, kept on the host to restore each run
    start = [p.detach().to("cpu", copy=True) for p in lm_params.parameters()]
    g = _cuda_gen(dev, DRYRUN_SEED + 1)
    tokens = torch.randint(0, cell.cfg.vocab, (b, TRAIN_SEQ), generator=g,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}

    def train_args():
        torch.cuda.empty_cache()
        with torch.no_grad():
            for p, s in zip(lm_params.parameters(), start):
                p.copy_(s)
        return (TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                           lm_params,
                           opt.init(to_reference_layout(lm_params))), batch)
    rec = hold_cell(cell, train_args, reps=2)

    def two_steps():
        state, _ = train_args()
        losses = []
        for _ in range(2):
            state, metrics = cell.fn(state, batch)
            losses.append(metrics["loss"])
        # on the host, so the second run has the card to itself
        return ([p.detach().to("cpu", copy=True)
                 for p in lm_params.parameters()],
                {k: v.to("cpu", copy=True)
                 for k, v in steps.leaves(state.opt_state).items()},
                [x.to("cpu", copy=True) for x in losses])
    p1, o1, l1 = two_steps()
    p2, o2, l2 = two_steps()
    same = (all(torch.equal(a, c) for a, c in zip(p1, p2))
            and all(torch.equal(o1[k], o2[k]) for k in o1)
            and all(torch.equal(a, c) for a, c in zip(l1, l2)))
    if not same:
        raise AssertionError("granite train_4k: two runs of two steps differ")
    rec.update(batch=b, seq=TRAIN_SEQ, cut_from=spec.shapes[
        "train_4k"].dims["batch"], peaks_reckoned_by_batch=peaks,
        bit_equal_twice=True, losses=[float(x) for x in l1])
    emit("dryrun_granite_train_4k_cut", **rec)
    return rec


def dryrun_phase(dev) -> dict:
    """Phase 3e: (a) every (architecture x shape) cell of the registry on
    both production meshes reckoned a chip on meta (84 records, no card
    memory, 0 failures; a line each, the records in
    OUT_DIR/dryrun_records.json); (b) the cells that fit one card run on the
    1 x 1 mesh at full width, each held against its reckoning
    (:func:`dryrun_card_cells`); the retrieval cells follow in
    :func:`dryrun_retrieval_phase`, on the planted index."""
    import torch
    from repro_torch.launch import analysis, dryrun
    smi = RECORD["device"]["nvidia_smi"]
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    recs = dryrun.run(dryrun.cells(mesh="both", all_cells=True),
                      verbose=False)
    reckon_s = time.perf_counter() - t0
    for r in recs:
        print(dryrun.line(r) if "error" not in r else
              f"[{r['arch']} x {r['shape']} @ {r['mesh']}] FAILED: "
              f"{r['error']}", flush=True)
    failures = [r for r in recs if "error" in r]
    if failures or len(recs) != 84:
        raise AssertionError(f"dry run: {len(recs)} records, "
                             f"{len(failures)} failures")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("the dry run's reckoning took card memory")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "dryrun_records.json"), "w") as f:
        json.dump(recs, f, indent=1)
    total = torch.cuda.get_device_properties(0).total_memory
    emit("dryrun_reckoned", card=smi, records=len(recs), failures=0,
         reckon_seconds=reckon_s, resident_before_gb=before / 1e9)
    cards = dryrun_card_cells(dev, smi)
    emit("dryrun", card=smi, records=len(recs), failures=0,
         reckon_seconds=reckon_s,
         card_total_memory=total,
         hbm_capacity_constant=analysis.HBM_CAPACITY,
         fits=sum(r["fits"] for r in recs),
         dominant={k: sum(r["dominant"] == k for r in recs)
                   for k in ("compute", "memory", "collective")},
         cells=cards, seconds=time.perf_counter() - t0)
    if total != analysis.HBM_CAPACITY:
        raise AssertionError(f"the card reports {total} bytes, the dry run "
                             f"reckons with {analysis.HBM_CAPACITY}")
    return {"cards": cards}


def dryrun_retrieval_phase(full: dict) -> dict:
    """Phase 5h2: the emvb-msmarco cells serve_b32 and serve_b1 on the 1 x 1
    mesh over the planted index: the cell's fn (make_shardmap_retriever at
    one NCCL rank, then the fused kernels) equal to retrieve in ids and
    score bits, the kernels' launches, and each held against its reckoning
    as :func:`hold_cell` does. -> the launches of each."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps
    from repro_torch.launch.mesh import single_card_mesh
    smi = RECORD["device"]["nvidia_smi"]
    index, cfg, queries = full["index"], full["cfg"], full["queries"]
    mesh = single_card_mesh()
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            stacked = serve.shard_index(index, 1)
            for shape, b in (("serve_b32", 32), ("serve_b1", 1)):
                q = queries[:b].clone()     # its own storage
                cell = steps.build_cell("emvb-msmarco", shape, mesh)
                ops.reset_launches()
                got = cell.fn(stacked, q)
                torch.cuda.synchronize()
                launches[shape] = ops.launch_counts()
                want = {"prefilter": 1, "pqinter": 1, "topnprobe": 1}
                if {k: v for k, v in launches[shape].items() if v} != want:
                    raise AssertionError(f"dryrun {shape}: launches "
                                         f"{launches[shape]}, expected {want}")
                if not _same_result(got, teng.retrieve(index, q, cfg)):
                    raise AssertionError(f"dryrun {shape}: the cell differs "
                                         "from retrieve")
                rec = hold_cell(cell, lambda: (stacked, q), reps=5)
                rec.update(equal_retrieve=True, launches=launches[shape])
                out[shape] = rec
            del stacked
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit("dryrun_retrieval", card=smi, cells=out)
    return {"launches": launches}


# --- 8b. examples: the port's examples at their default sizes ---------------

EXAMPLES = ("quickstart_torch", "streaming_index_torch",
            "retrieval_service_torch", "serve_retrieval_torch")


def examples_phase(sizes: dict = None) -> dict:
    """Phase 8b: each of the four examples' ``main()`` at its defaults on
    the card (``examples/*_torch.py``; ``sizes``, keyword arguments of
    every ``main``, shrink them for a rehearsal), its checks held, the
    kernels' launches of this process read around it (serve_retrieval's
    ranks are processes of their own: its count is the unsharded retrieve
    it is held against). -> the launches by example."""
    import importlib.util

    import torch
    from repro_torch.kernels import ops
    smi = RECORD["device"]["nvidia_smi"]
    out, launches = {}, {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        ops.reset_launches()
        t0 = time.perf_counter()
        res = mod.main(**(sizes or {}))
        torch.cuda.synchronize()
        launches[name] = ops.launch_counts()
        rec = {"seconds": time.perf_counter() - t0,
               "launches": launches[name]}
        if name == "quickstart_torch":
            rec.update(mrr_emvb=res["mrr_emvb"], mrr_plaid=res["mrr_plaid"],
                       emvb_ms=res["emvb_s"] * 1e3,
                       plaid_ms=res["plaid_s"] * 1e3)
            ok = launches[name]["cinter"] > 0
        elif name == "streaming_index_torch":
            rec.update(mrr=res["mrr"])
            ok = res["round_trip_exact"] and res["timeline_same"]
        elif name == "retrieval_service_torch":
            rec.update(hit_rate=res["stats"]["cache"]["hit_rate"])
            ok = res["exact"] and res["padded_equals_prefix"]
        else:
            rec.update(top1_agreement=res["top1_agreement"],
                       latency_ms=[x * 1e3 for x in res["latency_s"]])
            ok = res["top1_agreement"] == 1.0
        if not (ok and launches[name]["prefilter"]
                and launches[name]["pqinter"]):
            raise AssertionError(f"example {name}: {rec}")
        out[name] = rec
    emit("examples", card=smi, **out)
    return {"launches": launches}


# --- 6. timing ---------------------------------------------------------------

def time_samples(fn, n: int = 10, warmup: int = 2, flush=None) -> list:
    """CUDA-event times (ms) of ``n`` runs of ``fn`` after ``warmup``;
    ``flush`` (a large tensor) is rewritten before each run so L2 is cold."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def host_ms(fn, n: int = 20) -> float:
    """Median host time (ms) of one call of ``fn`` from an idle device to
    its return, without waiting for the device: what a wrapper costs the
    host to check, allocate and launch."""
    import torch
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_ms(fn, **kw) -> float:
    """Median of :func:`time_samples`."""
    return statistics.median(time_samples(fn, **kw))


def burst_ms(fn, n: int = 20, flush=None) -> float:
    """CUDA-event ms per call over ``n`` back-to-back calls of ``fn`` after
    one warm-up and one flush of L2: the launches queue behind each other,
    so the host's time between them hides behind the device's."""
    import torch
    fn()
    if flush is not None:
        flush.zero_()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def latency_stats(times: list) -> dict:
    """Median and the highest percentile with at least ten samples beyond
    it (p80 of 50, p90 of 100), with the sample count."""
    ts = sorted(times)
    n = len(ts)
    pct = 100 * (n - 10) // n // 10 * 10
    return {"median_ms": statistics.median(ts), f"p{pct}_ms":
            ts[min(n - 1, -(-pct * n // 100) - 1)], "n": n}


def in_turns(fns: dict, n: int, rounds: int = 5, flush=None) -> dict:
    """Two functions timed in turns (:func:`time_samples`): ``rounds``
    rounds of blocks in the order a, b, b, a, ``n`` samples of each in all,
    so a drift of the card's clocks or the host's load falls on both alike.
    -> the first's latency_stats, with the second's under
    "<name>_in_turns" and every block's median ms under "block_medians"."""
    a, b = fns
    per = max(1, n // (2 * rounds))
    samples = {a: [], b: []}
    blocks = {a: [], b: []}
    for _ in range(rounds):
        for k in (a, b, b, a):
            ts = time_samples(fns[k], n=per, warmup=1, flush=flush)
            samples[k] += ts
            blocks[k].append(statistics.median(ts))
    return {**latency_stats(samples[a]),
            f"{b}_in_turns": latency_stats(samples[b]),
            "block_medians": blocks}


def timing_phase(full: dict) -> dict:
    """Phase 5: every step of both lanes, end to end, each kernel beside its
    plain version and its bound, at B = 32 and B = 1."""
    import torch
    from repro_torch.core import bitvector
    from repro_torch.core import engine as teng
    from repro_torch.core.topk import topk
    from repro_torch.kernels import bitfilter as kbf
    from repro_torch.kernels import bitpack as kbp
    from repro_torch.kernels import cinter as kci
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import pqscore as kps
    from repro_torch.kernels import prefilter as kpf
    from repro_torch.kernels import topnprobe as ktp
    index, cfg, ucfg = full["index"], full["cfg"], full["ucfg"]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=index.device)
    out = {}
    for name, q in (("b32", full["queries"][:32]),
                    ("b1", full["queries"][:1])):
        h, u = full["held"][name], full["held_u"][name]
        cs, bitmap, sel1 = h["cs"], h["bitmap"], h["sel1"]
        probe = bitvector.masked_topk_centroids(cs, cfg.th, cfg.nprobe)
        pf_args = (cs, cfg.th, index.codes, index.doc_lens, bitmap,
                   cfg.n_filter)
        pq_args = (*h["operands"], cfg.th_r, cfg.n_docs, cfg.k)
        bf_args = (u["bits"], index.codes, index.doc_lens)
        f, sel2 = u["f"], u["sel2"]
        steps = {
            "cs_matmul": lambda: teng.centroid_scores(q, index.centroids),
            "topnprobe_kernel": lambda: bitvector.masked_topk_centroids(
                cs, cfg.th, cfg.nprobe),
            "bitmap": lambda: teng.candidate_bitmap(
                index.ivf, index.ivf_lens, probe, index.codes.shape[0]),
            "prefilter_kernel": lambda: ops.prefilter_batched(*pf_args),
            "cs_transpose": lambda: teng._transposed(cs),
            "lut_and_gathers": lambda: (
                teng._query_lut(index, q), index.codes[sel1],
                index.res_codes[sel1], index.doc_lens[sel1]),
            "pqinter_kernel": lambda: ops.pqinter_batched(*pq_args),
        }
        # the unfused lane's own steps; cs_matmul, topnprobe_kernel and
        # bitmap are the fused lane's
        usteps = {
            "bitpack_kernel": lambda: ops.bitpack_batched(cs, cfg.th),
            "bitfilter_kernel": lambda: ops.bitfilter_batched(*bf_args),
            "mask_and_topk_n_filter": lambda: topk(
                torch.where(bitmap, f, torch.full_like(f, -1)), cfg.n_filter),
            "cs_transpose": lambda: teng._transposed(cs),
            "survivor_gathers": lambda: (index.codes[sel1],
                                         index.doc_lens[sel1]),
            "cinter_kernel": lambda: ops.cinter_batched(*u["ci_args"]),
            "topk_n_docs": lambda: topk(u["sbar"], cfg.n_docs),
            "lut_and_gathers": lambda: (
                teng._query_lut(index, q), index.codes[sel2],
                index.res_codes[sel2], index.doc_lens[sel2]),
            "pqscore_kernel": lambda: ops.pqscore_batched(*u["ps_args"]),
            "final_topk": lambda: topk(u["score"], cfg.k),
        }
        ms = {k: time_ms(fn, flush=flush) for k, fn in steps.items()}
        ums = {k: time_ms(fn, flush=flush) for k, fn in usteps.items()}
        n_e2e = 50 if name == "b32" else 100
        e2e = latency_stats(time_samples(
            lambda: teng.retrieve(index, q, cfg), n=n_e2e, flush=flush))
        ue2e = latency_stats(time_samples(
            lambda: teng.retrieve(index, q, ucfg), n=n_e2e, flush=flush))
        ms["end_to_end"] = e2e["median_ms"]
        ums["end_to_end"] = ue2e["median_ms"]
        t0 = time.perf_counter()
        for _ in range(5):
            teng.retrieve(index, q, cfg)
        torch.cuda.synchronize()
        host_ms_e2e = (time.perf_counter() - t0) / 5 * 1e3
        plain = {
            "prefilter": time_ms(lambda: kpf.prefilter_batched_ref(*pf_args),
                                 n=3, warmup=1, flush=flush),
            "pqinter": time_ms(lambda: kpq.pqinter_batched_ref(*pq_args),
                               n=5, warmup=1, flush=flush),
            "bitpack": time_ms(lambda: kbp.bitpack_batched_ref(cs, cfg.th),
                               n=5, warmup=1, flush=flush),
            "bitfilter": time_ms(lambda: kbf.bitfilter_batched_ref(*bf_args),
                                 n=3, warmup=1, flush=flush),
            "cinter": time_ms(lambda: kci.cinter_batched_ref(*u["ci_args"]),
                              n=5, warmup=1, flush=flush),
            "pqscore": time_ms(lambda: kps.pqscore_batched_ref(
                *u["ps_args"]), n=5, warmup=1, flush=flush),
            "topnprobe": time_ms(lambda: ktp.masked_topk_ref(
                cs, cfg.th, cfg.nprobe), n=5, warmup=1, flush=flush),
        }
        wrapper_host = {
            "prefilter": host_ms(lambda: ops.prefilter_batched(*pf_args)),
            "pqinter": host_ms(lambda: ops.pqinter_batched(*pq_args)),
            "bitpack": host_ms(lambda: ops.bitpack_batched(cs, cfg.th)),
            "cinter": host_ms(lambda: ops.cinter_batched(*u["ci_args"])),
            "topnprobe": host_ms(lambda: ktp.masked_topk(
                cs, cfg.th, cfg.nprobe))}
        ci_cs_t, ci_codes, ci_lens = u["ci_args"]
        ps_cs_t, ps_lut, ps_codes, _, ps_lens, _ = u["ps_args"]
        bounds = {
            "prefilter": prefilter_bound(cs, index, bitmap, cfg.n_filter),
            "pqinter": pqinter_bound(h["operands"][0], h["operands"][1],
                                     h["operands"][2], h["operands"][4],
                                     h["pq"][2], cfg.n_docs, cfg.k),
            "bitpack": bitpack_bound(cs),
            "bitfilter": bitfilter_bound(q.shape[0], index, lit_shares(
                u["bits"], full["token_hist"])["lit_tokens"]),
            "cinter": cinter_bound(ci_cs_t, ci_codes, ci_lens),
            "pqscore": pqscore_bound(ps_cs_t, ps_lut, ps_codes, ps_lens),
            "topnprobe": topnprobe_bound(cs, cfg.nprobe),
        }
        nb = q.shape[0]
        out[name] = dict(step_ms=ms, end_to_end=e2e, unfused_step_ms=ums,
                         unfused_end_to_end=ue2e, plain_ms=plain,
                         bounds=bounds, host_ms_per_batch=host_ms_e2e,
                         wrapper_host_ms=wrapper_host,
                         qps=nb * 1e3 / ms["end_to_end"],
                         unfused_qps=nb * 1e3 / ums["end_to_end"])
        emit(f"timing_{name}", batch=nb, **out[name])
    return out


def filter_timing_phase(filt: dict) -> dict:
    """Phase 6, continued: each filtered or compact kernel form (FORMS) on its
    config's own operands at B = 32 and B = 1 — its median ms, its plain
    version's, its bound and its per-pass device ms —, the two steps the
    configs add (the pass mask, the candidate buffer), and retrieve end to
    end per config and lane."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.kernels import bitfilter as kbf
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import prefilter as kpf
    index = filt["index"]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=index.device)
    forms, e2e = {}, {}
    for name, conf in filt["configs"].items():
        for lane, c in conf["cfgs"].items():
            for b, n in (("b32", 20), ("b1", 50)):
                q = conf["held"][b]["q"]
                e2e.setdefault(name, {}).setdefault(lane, {})[b] = \
                    latency_stats(time_samples(
                        lambda: teng.retrieve(index, q, c), n=n,
                        flush=flush))
    # the two steps the configs add to retrieve: the pass mask over the
    # predicate plane, and the candidate buffer
    steps = {}
    for b in ("b32", "b1"):
        c = filt["configs"]["compact"]["cfgs"]["fused"]
        bitmap = filt["configs"]["compact"]["held"][b]["h"]["bitmap"]
        fc = filt["configs"]["filter1pct"]["cfgs"]["fused"]
        steps[b] = {
            "doc_pass": time_ms(lambda: teng._doc_pass(index, fc),
                                flush=flush),
            "compact_candidates": time_ms(
                lambda: teng._compact_candidates(bitmap, c), flush=flush)}
    for kern, kforms in FORMS.items():
        for form, (name, lane) in kforms.items():
            conf = filt["configs"][name]
            c = conf["cfgs"][lane]
            rec = {"config": name, "lane": lane,
                   "launches": conf["launches"][lane]["b32"][kern],
                   "launches_b1": conf["launches"][lane]["b1"][kern]}
            for b in ("b32", "b1"):
                h, u = conf["held"][b]["h"], conf["held"][b]["u"]
                if kern == "prefilter":
                    args, kw = h["pf_args"], h["pf_kw"]

                    def fn():
                        return ops.prefilter_batched(*args, **kw)

                    def plain():
                        return kpf.prefilter_batched_ref(*args, **kw)
                    bound = (prefilter_bound(h["cs"], index, h["bitmap"],
                                             c.n_filter, h["doc_pass"])
                             if form == "plan" else prefilter_query_bound(
                                 h["cs"], args[3], args[4], c.n_filter))
                elif kern == "pqinter":
                    args = (*h["operands"], c.th_r, c.n_docs, c.k)
                    dp = h["s1_pass"]

                    def fn():
                        return ops.pqinter_batched(*args, doc_pass=dp)

                    def plain():
                        return kpq.pqinter_batched_ref(*args, None, dp)
                    ops_ = h["operands"]
                    bound = pqinter_bound(ops_[0], ops_[1], ops_[2], ops_[4],
                                          h["pq"][2], c.n_docs, c.k, dp)
                else:
                    args = u["bf_args"]

                    def fn():
                        return (ops.bitfilter_batched(*args),)

                    def plain():
                        return (kbf.bitfilter_batched_ref(*args),)
                    bound = bitfilter_query_bound(*args)
                sfx = "" if b == "b32" else "_b1"
                rec["max_abs_err" + sfx] = _exact(fn(), plain())
                rec["ms" + sfx] = time_ms(fn, flush=flush)
                rec["plain_ms" + sfx] = time_ms(plain, n=3, warmup=1,
                                                flush=flush)
                rec["bound" + sfx] = bound
                rec["pass_ms" + sfx], rec["pass_launches" + sfx] = \
                    _passes(fn, kern)
            forms.setdefault(kern, {})[form] = rec
    out = {"forms": forms, "end_to_end": e2e, "step_ms": steps}
    emit("timing_filter", **out)
    return out


# --- 6b. bf16 CS --------------------------------------------------------------

# The bf16 configs: name -> (the 1 % filter or none, candidate mode).
BF16_CONFIGS = {"unfiltered": (False, "score_all"),
                "filter1pct": (True, "score_all"),
                "compact": (False, "compact")}


def lane_differences(index, q, cfg, ucfg, h, u) -> dict:
    """Where the two lanes differ on bf16 CS (the same CS and LUT), and
    whether each difference traces to an entry equal to bf16(th): there the
    fused prefilter packs bit 0 (a bf16 comparison) and the unfused bitpack
    bit 1 (float32), as the reference's kernels do. Raises unless the two
    lanes' bit words differ exactly at those entries and every query whose
    words agree gets the same results from both lanes (finite entries)."""
    import torch
    from repro_torch.core import bitvector
    from repro_torch.core import engine as teng
    from repro_torch.core.precision import round_to
    cs = h["cs"]
    edge = cs.float() == round_to(cfg.th, torch.bfloat16)
    edge_words = bitvector.build_bitvectors(edge.float(), 0.5)
    fused_bits, unfused_bits = h["pf"][2], u["bits"]
    if not torch.equal(fused_bits ^ unfused_bits, edge_words):
        raise AssertionError("bf16: the lanes' bit words differ elsewhere "
                             "than at entries equal to bf16(th)")
    a = teng._retrieve_batch(index, q, cfg, cs=cs, lut=h["lut"])
    z = teng._retrieve_batch(index, q, ucfg, cs=cs, lut=h["lut"])
    fin = torch.isfinite(a.scores)
    same = ((fin == torch.isfinite(z.scores))
            & (~fin | ((a.doc_ids == z.doc_ids) & (
                a.scores.view(torch.int32) == z.scores.view(torch.int32)))))
    words_differ = (fused_bits != unfused_bits).any(1)
    rows = ~same.all(1)
    if (rows & ~words_differ).any():
        raise AssertionError("bf16: the lanes' results differ on a query "
                             "whose bit words agree")
    return {"entries_equal_bf16_th": int(edge.sum()),
            "queries_with_such_entries": int(words_differ.sum()),
            "queries_whose_results_differ": int(rows.sum()),
            "results_that_differ": int((~same).sum()),
            "every_difference_traced_to_bf16_th": True}


def bf16_phase(dev, full: dict, filt: dict) -> dict:
    """Phase 6b: bf16 CS (``cs_dtype="bfloat16"``, paper §6) on the planted
    index with its predicate plane. Each kernel's bf16 form against its
    plain version on the small stress cases (:func:`small_phase`) and at
    full width; retrieve on both lanes at B = 32 and B = 1, unfiltered,
    with the 1 % filter and in compact mode, the launch counts read around
    those calls, the results checked (planted Success@100 >= SUCCESS_FLOOR
    unfiltered) and held step by step; the lanes' differences, each traced
    to an entry equal to bf16(th) (:func:`lane_differences`); then each
    bf16 kernel form's ms, plain ms, bound and per-pass device ms, its ms
    per call in bursts beside the float32 form's (in turns: float32, bf16,
    bf16, float32), the fused lane's steps, and retrieve's ms per config
    and lane, in turns with float32 on the same queries (:func:`in_turns`)."""
    import torch
    from repro_torch.core import bitvector
    from repro_torch.core import engine as teng
    from repro_torch.data import synthetic
    from repro_torch.kernels import bitpack as kbp
    from repro_torch.kernels import cinter as kci
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqinter as kpq
    from repro_torch.kernels import pqscore as kps
    from repro_torch.kernels import prefilter as kpf
    small_err = small_phase(dev, "bfloat16")
    index, queries = filt["index"], full["queries"]
    plan = filt["configs"]["filter1pct"]["cfgs"]["fused"].doc_filter
    passing = bitvector.apply_filter_plan(plan, index.pred_words)
    batches = [queries[s:s + 32] for s in range(0, N_QUERIES, 32)]
    gt_np = full["gt"].cpu().numpy()
    configs = {}
    for name, (filtered, mode) in BF16_CONFIGS.items():
        over = dict(cs_dtype="bfloat16", candidate_mode=mode,
                    cand_cap=CAND_CAP, doc_filter=plan if filtered else None)
        cfgs = {"fused": dataclasses.replace(full["cfg"], **over),
                "unfused": dataclasses.replace(full["ucfg"], **over)}
        ok = passing if filtered else None
        launches, results, quality, fillers = {}, {}, {}, {}
        for lane, c in cfgs.items():
            ops.reset_launches()
            res = [teng.retrieve(index, q, c) for q in batches]
            torch.cuda.synchronize()
            launches[lane] = {"b32": ops.launch_counts()}
            ops.reset_launches()
            res1 = [teng.retrieve(index, queries[i:i + 1], c)
                    for i in range(N_SINGLE)]
            torch.cuda.synchronize()
            launches[lane]["b1"] = ops.launch_counts()
            for kname, kern in KERNELS.items():
                want = ((len(batches), N_SINGLE) if _on_lane(kern, lane)
                        else (0, 0))
                got = tuple(launches[lane][b][kname] for b in ("b32", "b1"))
                if got != want:
                    raise AssertionError(f"bf16 {name} {lane}: {kname} "
                                         f"launched {got}, expected {want}")
            ids = torch.cat([r.doc_ids for r in res])
            ids1 = torch.cat([r.doc_ids for r in res1])
            fillers[lane] = {
                "b32": check_filtered(ids, torch.cat([r.scores for r in res]),
                                      ok),
                "b1": check_filtered(ids1, torch.cat([r.scores
                                                      for r in res1]), ok)}
            quality[lane] = {
                "success_at_100": synthetic.success_at_k(
                    ids.cpu().numpy(), gt_np, 100),
                "success_at_100_b1": synthetic.success_at_k(
                    ids1.cpu().numpy(), gt_np[:N_SINGLE], 100)}
            if name == "unfiltered" and min(quality[lane].values()) \
                    < SUCCESS_FLOOR:
                raise AssertionError(f"bf16 {lane} lane: planted "
                                     f"Success@100 {quality[lane]} < "
                                     f"{SUCCESS_FLOOR}")
            results[lane] = {"b32": res[0], "b1": res1[0]}
        held, diffs = {}, {}
        for b, q in (("b32", batches[0]), ("b1", queries[:1])):
            h = hold_phases(index, q, cfgs["fused"])
            u = hold_unfused(index, q, cfgs["unfused"], h)
            for lane, got in (("fused", (h["ids"], h["pq"][0])),
                              ("unfused", (u["ids"], u["scores"]))):
                ref = results[lane][b]
                if not (torch.equal(got[0], ref.doc_ids) and torch.equal(
                        got[1].view(torch.int32),
                        ref.scores.view(torch.int32))):
                    raise AssertionError(f"bf16 {name} {lane} {b}: the held "
                                         "phases do not compose to retrieve")
            diffs[b] = lane_differences(index, q, cfgs["fused"],
                                        cfgs["unfused"], h, u)
            held[b] = {"h": h, "u": u, "q": q}
        configs[name] = dict(cfgs=cfgs, held=held, launches=launches)
        emit(f"bf16_{name}", candidate_mode=mode, filtered=filtered,
             launches=launches, phases_exact=True, quality=quality,
             fillers=fillers, lane_differences=diffs,
             max_abs_err={b: {**v["h"]["err"], **v["u"]["err"]}
                          for b, v in held.items()})

    flush = torch.empty(64 << 20, dtype=torch.int32, device=index.device)
    e2e = {}
    for name, conf in configs.items():
        n32, n1 = (50, 100) if name == "unfiltered" else (20, 50)
        for lane, c in conf["cfgs"].items():
            c32 = dataclasses.replace(c, cs_dtype="float32")
            for b, n in (("b32", n32), ("b1", n1)):
                q = conf["held"][b]["q"]
                e2e.setdefault(name, {}).setdefault(lane, {})[b] = in_turns(
                    {"bf16": lambda: teng.retrieve(index, q, c),
                     "float32": lambda: teng.retrieve(index, q, c32)},
                    n, flush=flush)
    conf = configs["unfiltered"]
    cfg = conf["cfgs"]["fused"]
    forms, steps = {}, {}
    for b in ("b32", "b1"):
        h, u, q = (conf["held"][b][k] for k in ("h", "u", "q"))
        fh, fu = full["held"][b], full["held_u"][b]     # float32, same q
        cs = h["cs"]
        probe = bitvector.masked_topk_centroids(cs, cfg.th, cfg.nprobe)
        steps[b] = {k: time_ms(fn, flush=flush) for k, fn in {
            "cs_matmul": lambda: teng.centroid_scores(
                q, index.centroids, "bfloat16"),
            "topnprobe_kernel": lambda: bitvector.masked_topk_centroids(
                cs, cfg.th, cfg.nprobe),
            "bitmap": lambda: teng.candidate_bitmap(
                index.ivf, index.ivf_lens, probe, index.codes.shape[0]),
            "prefilter_kernel": lambda: ops.prefilter_batched(
                *h["pf_args"]),
            "cs_transpose": lambda: teng._transposed(cs),
            "lut_and_gathers": lambda: (
                teng._query_lut(index, q), index.codes[h["sel1"]],
                index.res_codes[h["sel1"]], index.doc_lens[h["sel1"]]),
            "pqinter_kernel": lambda: ops.pqinter_batched(
                *h["operands"], cfg.th_r, cfg.n_docs, cfg.k),
        }.items()}
        pq_args = (*h["operands"], cfg.th_r, cfg.n_docs, cfg.k)
        ci, ps = u["ci_args"], u["ps_args"]
        cases = {
            "prefilter": (lambda: ops.prefilter_batched(*h["pf_args"]),
                          lambda: kpf.prefilter_batched_ref(*h["pf_args"]),
                          prefilter_bound(cs, index, h["bitmap"],
                                          cfg.n_filter)),
            "pqinter": (lambda: ops.pqinter_batched(*pq_args),
                        lambda: kpq.pqinter_batched_ref(*pq_args),
                        pqinter_bound(h["operands"][0], h["operands"][1],
                                      h["operands"][2], h["operands"][4],
                                      h["pq"][2], cfg.n_docs, cfg.k)),
            "bitpack": (lambda: (ops.bitpack_batched(cs, cfg.th),),
                        lambda: (kbp.bitpack_batched_ref(cs, cfg.th),),
                        bitpack_bound(cs)),
            "cinter": (lambda: (ops.cinter_batched(*ci),),
                       lambda: (kci.cinter_batched_ref(*ci),),
                       cinter_bound(*ci)),
            "pqscore": (lambda: (ops.pqscore_batched(*ps),),
                        lambda: (kps.pqscore_batched_ref(*ps),),
                        pqscore_bound(ps[0], ps[1], ps[2], ps[4])),
        }
        # the float32 forms on the same queries, timed in turns with bf16
        f32_fns = {
            "prefilter": lambda: ops.prefilter_batched(*fh["pf_args"]),
            "pqinter": lambda: ops.pqinter_batched(
                *fh["operands"], cfg.th_r, cfg.n_docs, cfg.k),
            "bitpack": lambda: ops.bitpack_batched(fh["cs"], cfg.th),
            "cinter": lambda: ops.cinter_batched(*fu["ci_args"]),
            "pqscore": lambda: ops.pqscore_batched(*fu["ps_args"]),
        }
        sfx = "" if b == "b32" else "_b1"
        for kern, (fn, plain, bound) in cases.items():
            lane = KERNELS[kern]["lane"]
            rec = forms.setdefault(kern, {"config": "bf16", "lane": lane})
            rec["launches" + sfx] = conf["launches"][lane][b][kern]
            rec["max_abs_err" + sfx] = max(small_err[kern],
                                           _exact(fn(), plain()))
            rec["ms" + sfx] = time_ms(fn, flush=flush)
            rec["plain_ms" + sfx] = time_ms(plain, n=3, warmup=1,
                                            flush=flush)
            rec["bound" + sfx] = bound
            rec["pass_ms" + sfx], rec["pass_launches" + sfx] = \
                _passes(fn, kern)
            turns = {"float32": [], "bf16": []}
            for dt in ("float32", "bf16", "bf16", "float32"):
                turns[dt].append(burst_ms(
                    f32_fns[kern] if dt == "float32" else fn, flush=flush))
            rec["burst_ms" + sfx] = {dt: statistics.median(v)
                                     for dt, v in turns.items()}
    out = {"forms": {k: {"bf16": v} for k, v in forms.items()},
           "end_to_end": e2e, "step_ms": steps}
    emit("timing_bf16", **out)
    return out


# --- 7. kernels away from the default config ---------------------------------

def _passes(fn, kern: str, calls: int = 3) -> tuple:
    """Device ms and launches per call of each __global__ function of
    ``kern`` over ``calls`` calls of ``fn`` (:func:`_profiled`). A profile
    that lost launches (:func:`_whole`) is taken again, up to three
    times; if all three lose some, the ms are None."""
    for _ in range(3):
        prof, _ = _profiled(fn, calls)
        mine = _pass_events(_device_events(prof), kern)
        launches = {f: sum(e.count for e in es) for f, es in mine.items()}
        if _whole(launches, calls):
            break
    ms = {f: sum(_dev_us(e) for e in es) / 1e3 / calls
          for f, es in mine.items()}
    return (ms if _whole(launches, calls) else None,
            {f: n / calls for f, n in launches.items()})


def _whole(launches: dict, calls: int) -> bool:
    """Whether a profile saw some launches of a kernel's __global__
    functions and a whole number of each per call: the profiler at times
    loses a launch's device event (in one run 1 of 3 calls of every pass
    of one prefilter case, and none of its pack pass), and a lost event
    would make a pass look faster than the card can run it."""
    return sum(launches.values()) > 0 and all(
        n % calls == 0 for n in launches.values())


def th_for_rho(cs, hist, rho: float) -> float:
    """A threshold at which the word table of cs (B, n_q, n_c) lights rows
    holding about a share rho of the corpus' valid tokens (hist: per
    centroid): the rows whose largest term score beats it, taken from the
    largest down. rho >= 1 lights every row."""
    import torch
    rowmax = cs.amax(dim=(0, 1))
    if rho >= 1.0:
        return float(rowmax.min()) - 1.0
    order = torch.argsort(rowmax, descending=True)
    cum = hist[order].cumsum(0).double() / hist.sum()
    k = min(int((cum < rho).sum()), rowmax.numel() - 2)
    return float((rowmax[order[k]] + rowmax[order[k + 1]]) / 2)


# The limits phase's cuts: the prefilter's n_filter, and pqinter's
# survivors -> the n_docs each case keeps (4096: the largest cut of the
# shared-memory forms; 20,000 -> 10,000: the radix select).
PREFILTER_LIMITS = (1024, 4096, 8192, 16384, 65536)
PQINTER_LIMITS = {4096: (256, 4096), 20_000: (10_000,)}


def plain_pqinter(operands, th_r, n_docs: int, k: int, doc_pass=None,
                  step: int = 2):
    """pqinter's plain version ``step`` queries at a time: its (docs, cap,
    n_q) gathers take about 1 GB a query at 10,000 winners, too much for a
    whole batch beside the index."""
    import torch
    from repro_torch.kernels import pqinter as kpq
    nb = operands[0].shape[0]
    parts = [kpq.pqinter_batched_ref(
        *(x[s:s + step] for x in operands), th_r, n_docs, k, None,
        None if doc_pass is None else doc_pass[s:s + step])
        for s in range(0, nb, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def limits_phase(full: dict) -> dict:
    """Phase 6: kernels at full width on inputs the default config does not
    give them, each held exactly against its plain version. The two
    megakernels: the prefilter at B = 32 on batches whose queries share
    candidates (every query with query 0's candidates; each doc of the
    batch's union a candidate of queries 0..k-1, k in {8, 16, 24, 32}),
    and cuts larger than the default config's (n_filter 1024 to 65,536;
    pqinter over 4096 survivors keeping 256 and 4096, and over 20,000
    keeping 10,000: the radix select), at B = 32 and B = 1.
    bitfilter on dense word tables: the batch's CS packed at a th low enough
    that the lit rows hold about 50 % and 100 % of the corpus' valid tokens
    (a real index lights far more rows than the planted one), at B = 32 and
    B = 1. pqscore over those 4096 survivors as winners. Per case: the
    wrapper's median ms (as in the timing phase) and its per-pass device
    ms."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.kernels import bitfilter as kbf
    from repro_torch.kernels import ops
    from repro_torch.kernels import pqscore as kps
    from repro_torch.kernels import prefilter as kpf
    index, cfg = full["index"], full["cfg"]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=index.device)
    out = {}

    def case(name, kern, fn, ref):
        _exact(fn(), ref())
        pass_ms, pass_launches = _passes(fn, kern)
        out[name] = {"ms": time_ms(fn, flush=flush), "pass_ms": pass_ms,
                     "pass_launches": pass_launches}

    h = full["held"]["b32"]
    bm = h["bitmap"]
    union = bm.any(0, keepdim=True)
    first = torch.arange(bm.shape[0], device=bm.device)[:, None]
    for name, bitmap in (
            ("planted", bm),
            ("query0_candidates", bm[:1].expand_as(bm).contiguous()),
            *((f"union_to_first{k}_queries", (union & (first < k)))
              for k in (8, 16, 24)),
            ("union_candidates", union.expand_as(bm).contiguous())):
        args = (h["cs"], cfg.th, index.codes, index.doc_lens, bitmap,
                cfg.n_filter)
        case(f"prefilter_{name}_b32", "prefilter",
             lambda: ops.prefilter_batched(*args),
             lambda: kpf.prefilter_batched_ref(*args))
        out[f"prefilter_{name}_b32"].update(
            candidate_pairs=int(bitmap.sum()),
            bound=prefilter_bound(h["cs"], index, bitmap, cfg.n_filter))
    for b in ("b32", "b1"):
        h = full["held"][b]
        q = full["queries"][:h["cs"].shape[0]]
        for n_filter in PREFILTER_LIMITS:
            args = (h["cs"], cfg.th, index.codes, index.doc_lens,
                    h["bitmap"], n_filter)
            case(f"prefilter_n_filter{n_filter}_{b}", "prefilter",
                 lambda: ops.prefilter_batched(*args),
                 lambda: kpf.prefilter_batched_ref(*args))
        winners = None
        for nf, cuts in PQINTER_LIMITS.items():
            sel1 = ops.prefilter_batched(*args[:5], nf)[1].long()
            operands = teng._survivor_operands(index, h["cs"],
                                               teng._query_lut(index, q), sel1)
            for n_docs in cuts:
                name = f"pqinter_nf{nf}_n_docs{n_docs}_{b}"
                case(name, "pqinter",
                     lambda: ops.pqinter_batched(*operands, cfg.th_r, n_docs,
                                                 cfg.k),
                     lambda: plain_pqinter(operands, cfg.th_r, n_docs, cfg.k,
                                           step=4))
                out[name]["eq56_plan"] = eq56_plan_of("pqinter", operands,
                                                      n_docs)
            winners = winners or operands   # pqscore over the first's
        operands = winners

        def ps_ref():
            return (torch.cat([kps.pqscore_batched_ref(
                *(x[s:s + 4] for x in operands), cfg.th_r)
                for s in range(0, operands[0].shape[0], 4)]),)
        name = f"pqscore_winners{operands[0].shape[1]}_{b}"
        case(name, "pqscore",
             lambda: (ops.pqscore_batched(*operands, cfg.th_r),), ps_ref)
        out[name]["bound"] = pqscore_bound(operands[0], operands[1],
                                           operands[2], operands[4])
        out[name]["eq56_plan"] = eq56_plan_of("pqscore", operands)
        for rho in (0.5, 1.0):
            th = th_for_rho(h["cs"], full["token_hist"], rho)
            args = (ops.bitpack_batched(h["cs"], th), index.codes,
                    index.doc_lens)
            name = f"bitfilter_rho{round(rho * 100)}_{b}"
            case(name, "bitfilter", lambda: (ops.bitfilter_batched(*args),),
                 lambda: (kbf.bitfilter_batched_ref(*args),))
            lit = lit_shares(args[0], full["token_hist"])
            out[name].update(th=th, **lit, bound=bitfilter_bound(
                args[0].shape[0], index, lit["lit_tokens"]))
    emit("limits", **out)
    return out


# --- 7b. budgets: cuts past the old shared-memory caps --------------------

# fig9's post-filter lane (benchmarks/fig9_selectivity.py:73-76) at
# emvb-msmarco's k = 100 (src/repro/configs/emvb_msmarco.py:23) and the
# sweep's s = 0.02: k_post = 2 * ceil(k / s) = 10,000 = n_docs, n_filter =
# 2 * k_post.
BUDGET_FIG9 = dict(ENGINE, k=10_000, n_docs=10_000, n_filter=20_000)
# fig2's no-prefilter baseline (benchmarks/fig2_threshold.py:34-37): every
# doc survives phase 2.
BUDGET_FIG2 = dict(ENGINE, th=-1.0, th_r=None, n_filter=WIDTHS["n_docs"],
                   n_docs=128, k=100)
# case -> (config, CS dtype, B, filter predicate or None)
BUDGET_CASES = {
    "fig9_b32": (BUDGET_FIG9, "float32", 32, None),
    "fig9_b1": (BUDGET_FIG9, "float32", 1, None),
    "fig9_bf16_b32": (BUDGET_FIG9, "bfloat16", 32, None),
    "fig9_bf16_b1": (BUDGET_FIG9, "bfloat16", 1, None),
    "fig9_filter1pct_b32": (BUDGET_FIG9, "float32", 32, "p1"),
    "fig2_b1": (BUDGET_FIG2, "float32", 1, None),
}




def budget_case(index, q, cfg, ucfg, flush) -> dict:
    """One budgets case. retrieve on each lane (launches counted around one
    call each, every kernel on its own lane only; ms; the fused call's peak
    memory); the fused lane's steps held (:func:`hold_phases`: each kernel
    against its plain version, pqinter's two queries at a time, or not at
    fig2's 8,841,823 survivors, whose (docs, cap, n_q) gathers no card
    holds) and composed to retrieve's result; each fused kernel's ms and
    per-pass device ms beside its bound and its plain version's ms; the
    unfused lane on the same CS and LUT equal to the fused one (on the
    finite entries with a filter, whose fillers differ by lane; on bf16 CS
    every difference traced to an entry equal to bf16(th),
    :func:`lane_differences`)."""
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    from repro_torch.kernels import prefilter as kpf
    launches, ms = {}, {}
    for lane, c in (("fused", cfg), ("unfused", ucfg)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        res = teng.retrieve(index, q, c)
        torch.cuda.synchronize()
        launches[lane] = ops.launch_counts()
        if lane == "fused":
            fused, peak = res, torch.cuda.max_memory_allocated()
        ms[lane] = time_ms(lambda: teng.retrieve(index, q, c), n=5, warmup=1)
        for kname, kern in KERNELS.items():
            if (launches[lane][kname] > 0) != _on_lane(kern, lane):
                raise AssertionError(f"{lane} lane: {kname} launched "
                                     f"{launches[lane][kname]} times")
    plain_pq = cfg.n_filter < index.codes.shape[0]
    h = hold_phases(index, q, cfg, plain_step=2 if plain_pq else 0)
    if not (torch.equal(h["ids"], fused.doc_ids) and torch.equal(
            h["pq"][0].view(torch.int32), fused.scores.view(torch.int32))):
        raise AssertionError("the held kernels do not compose to retrieve")
    ops_, tail = h["operands"], (cfg.th_r, cfg.n_docs, cfg.k)
    kern = {}
    for name, fn, plain, bound in (
            ("prefilter",
             lambda: ops.prefilter_batched(*h["pf_args"], **h["pf_kw"]),
             lambda: kpf.prefilter_batched_ref(*h["pf_args"], **h["pf_kw"]),
             lambda: prefilter_bound(h["cs"], index, h["bitmap"],
                                     cfg.n_filter, h["doc_pass"])),
            ("pqinter",
             lambda: ops.pqinter_batched(*ops_, *tail, doc_pass=h["s1_pass"]),
             (lambda: plain_pqinter(ops_, *tail, h["s1_pass"])) if plain_pq
             else None,
             lambda: pqinter_bound(ops_[0], ops_[1], ops_[2], ops_[4],
                                   h["pq"][2], cfg.n_docs, cfg.k,
                                   h["s1_pass"]))):
        pass_ms, pass_launches = _passes(fn, name)
        kern[name] = dict(
            max_abs_err=h["err"][name],
            ms=time_ms(fn, n=5, warmup=1, flush=flush),
            plain_ms=None if plain is None else time_ms(plain, n=3,
                                                        warmup=1),
            pass_ms=pass_ms, pass_launches=pass_launches, bound=bound())
    kern["pqinter"]["eq56_plan"] = eq56_plan_of("pqinter", ops_, cfg.n_docs)
    term_filter = term_filter_shares(h, cfg)
    cs, lut, pf = h["cs"], h["lut"], h["pf"]
    del h, ops_                         # fig2's 14.1 GB of survivor operands
    if cfg.cs_dtype == "bfloat16":
        lanes = lane_differences(index, q, cfg, ucfg,
                                 {"cs": cs, "pf": pf, "lut": lut},
                                 {"bits": ops.bitpack_batched(cs, cfg.th)})
    else:
        lanes = {"unfused_equals_fused": True, "finite": _lanes_agree(
            teng._retrieve_batch(index, q, cfg, cs=cs, lut=lut),
            teng._retrieve_batch(index, q, ucfg, cs=cs, lut=lut),
            "budgets", finite_only=cfg.doc_filter is not None)}
    return {"ms": ms["fused"], "unfused_ms": ms["unfused"],
            "launches": launches, "max_memory_allocated_gb": peak / 1e9,
            "kernels": kern, "lanes": lanes, "term_filter": term_filter,
            "finite_results": int(torch.isfinite(fused.scores).sum()),
            "results": int(fused.scores.numel())}


def budgets_phase(full: dict, filt: dict) -> dict:
    """Phase 7b: the two configurations the reference's benchmarks run past
    the old shared-memory caps, on the full-width planted index (with the
    filter phase's predicate plane for the filtered case): fig9's
    post-filter lane (n_filter 20,000, n_docs = k = 10,000) at B = 32 and 1,
    float32 and bf16 CS and with the 1 % filter, and fig2's baseline
    (n_filter = all 8,841,823 docs, n_docs 128, k 100, th = -1, th_r None) at
    B = 1; per case :func:`budget_case`, the card's name and power limit
    beside the numbers."""
    import torch
    from repro_torch.core import engine as teng
    index = filt["index"]
    plan = filt["configs"]["filter1pct"]["cfgs"]["fused"].doc_filter
    flush = torch.empty(64 << 20, dtype=torch.int32, device=index.device)
    out = {"nvidia_smi": RECORD["device"]["nvidia_smi"]}
    for name, (kw, dt, nb, pred) in BUDGET_CASES.items():
        t0 = time.perf_counter()
        cfg = teng.EngineConfig(**kw, use_kernels=True, cs_dtype=dt,
                                doc_filter=None if pred is None else plan)
        ucfg = dataclasses.replace(cfg, fused_prefilter=False,
                                   fused_late_interaction=False)
        out[name] = budget_case(index, full["queries"][:nb], cfg, ucfg,
                                flush)
        out[name]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    emit("budgets", **out)
    return out


# --- 8. device time by kernel ------------------------------------------------

# The __global__ functions each wrapper launches, in launch order.
KERNEL_FUNCTIONS = {
    "prefilter": ("pack_kernel", "transpose_kernel", "score_kernel",
                  "score_query_kernel", "bin_rank_kernel", "place_kernel"),
    "pqinter": ("sbar_kernel", "select1_kernel", "select_pass_kernel",
                "select_compact_kernel", "rank_sort_kernel",
                "rank_count_kernel", "eq56_kernel", "eq56_l2_kernel",
                "select2_kernel"),
    "bitpack": ("bitpack_kernel",),
    "bitfilter": ("bitfilter_rows_kernel", "bitfilter_score_kernel",
                  "bitfilter_query_kernel"),
    "cinter": ("cinter_kernel",),
    "pqscore": ("pqscore_kernel", "pqscore_l2_kernel"),
    "topnprobe": ("topnprobe_kernel", "topnprobe_select_kernel",
                  "topnprobe_compact_kernel", "topnprobe_rank_kernel"),
}


def _dev_us(e) -> float:
    """A profiler event's own device time, us (the attribute's name differs
    between torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def _device_events(prof) -> list:
    """The profiler's device-side events (kernels, copies) with time, the
    longest first: an aten op's row repeats the time of its kernels, and so
    does the schedule's ProfilerStep row."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _dev_us(e) > 0
                   and not e.key.startswith("ProfilerStep")),
                  key=_dev_us, reverse=True)


def _pass_events(events: list, kern: str) -> dict:
    """{__global__ function of ``kern``: its events}."""
    return {fn: [e for e in events if _launched(e.key, fn)]
            for fn in KERNEL_FUNCTIONS[kern]}


def _launched(key: str, fn: str) -> bool:
    """Whether a profiler key names the __global__ function ``fn`` of an
    anonymous namespace (a template's key starts with its return type)."""
    return re.match(rf"(?:void )?\(anonymous namespace\)::{fn}[<(]",
                    key) is not None


def _profiled(fn, calls: int, reset=None) -> tuple:
    """torch.profiler over ``calls`` calls of ``fn``, after a traced
    warm-up round of as many calls whose events are dropped (the
    profiler's own schedule): without it the profiler lost the device
    events of the first launches it traced (4 of 5 bitpack launches over 5
    retrieve calls; 1 of 3 of a short kernel's). ``reset`` runs just
    before the recorded round. -> (the profile, that round's wall us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for recorded in (False, True):
            if recorded and reset is not None:
                reset()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    return prof, wall_us


def profile_phase(full: dict, calls: int = 5) -> dict:
    """Phase 7: ``torch.profiler`` over ``calls`` ``retrieve`` calls of each
    lane at B = 32 and B = 1 on the index already built, on float32 CS and
    on bf16 CS (``<lane>_bf16_b<B>``): the device's busy share of the
    profiled window, device time and launches per call by CUDA kernel, and
    each hand-written kernel's __global__ launches per wrapper call. The
    profiler's table goes to OUT_DIR/profile_<name>.txt."""
    from repro_torch.core import engine as teng
    from repro_torch.kernels import ops
    index = full["index"]
    smi = RECORD["device"]["nvidia_smi"]
    out = {}
    runs = []
    for lane in ("fused", "unfused"):
        cfg = full["cfg" if lane == "fused" else "ucfg"]
        for dt, c in (("", cfg), ("_bf16", dataclasses.replace(
                cfg, cs_dtype="bfloat16"))):
            runs += [(f"{lane}{dt}_b32", c, full["queries"][:32]),
                     (f"{lane}{dt}_b1", c, full["queries"][:1])]
    for name, cfg, q in runs:
        for attempt in range(1, 4):         # again if it lost launches
            prof, wall_us = _profiled(lambda: teng.retrieve(index, q, cfg),
                                      calls, reset=ops.reset_launches)
            wrapper_calls = ops.launch_counts()
            events = _device_events(prof)
            if not events:
                raise AssertionError("the profiler saw no device time")
            mine = {kern: _pass_events(events, kern)
                    for kern in KERNEL_FUNCTIONS if wrapper_calls[kern]}
            if all(_whole({f: sum(e.count for e in es)
                           for f, es in m.items()}, wrapper_calls[kern])
                   for kern, m in mine.items()):
                break
        averages = prof.key_averages()
        busy_us = sum(_dev_us(e) for e in events)
        per_wrapper, pass_ms = {}, {}
        for kern, m in mine.items():        # this lane's kernels
            per_wrapper[kern] = sum(
                e.count for es in m.values() for e in es) / \
                wrapper_calls[kern]
            pass_ms[kern] = {fn: sum(_dev_us(e) for e in es) / 1e3
                             / wrapper_calls[kern] for fn, es in m.items()}
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
            f.write(f"{smi}\n" + averages.table(
                sort_by="self_cuda_time_total", row_limit=40) + "\n")
        b = name.rsplit("_", 1)[1]
        eq56 = (eq56_plan_of("pqinter", full["held"][b]["operands"],
                             cfg.n_docs) if name.startswith("fused")
                else eq56_plan_of("pqscore", full["held_u"][b]["ps_args"]))
        out[name] = {
            "calls": calls, "attempts": attempt, "eq56_plan": eq56,
            "wall_ms_per_call": wall_us / calls / 1e3,
            "device_busy_ms_per_call": busy_us / calls / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_launches_per_call": sum(e.count for e in events) / calls,
            "kernel_launches_per_wrapper_call": per_wrapper,
            "pass_device_ms_per_wrapper_call": pass_ms,
            "by_kernel_ms_per_call": {
                e.key[:90]: _dev_us(e) / calls / 1e3 for e in events[:25]},
            "launches_per_call": {
                e.key[:90]: e.count / calls for e in events[:25]},
        }
        emit(f"profile_{name}", **out[name])
    return out


# --- 9. the kernels line -----------------------------------------------------

KERNELS = {
    "prefilter": dict(
        lane="fused",
        source="src/repro_torch/kernels/csrc/prefilter.cu",
        replaces="src/repro/kernels/prefilter.py:163",
        replaces_b1="src/repro/kernels/prefilter.py:258"),
    "pqinter": dict(
        lane="fused",
        source="src/repro_torch/kernels/csrc/pqinter.cu",
        replaces="src/repro/kernels/pqinter.py:322",
        replaces_b1="src/repro/kernels/pqinter.py:159"),
    "bitpack": dict(
        lane="unfused",
        source="src/repro_torch/kernels/csrc/bitpack.cu",
        replaces="src/repro/kernels/bitpack.py:33"),
    "bitfilter": dict(
        lane="unfused",
        source="src/repro_torch/kernels/csrc/bitfilter.cu",
        replaces="src/repro/kernels/bitfilter.py:45"),
    "cinter": dict(
        lane="unfused",
        source="src/repro_torch/kernels/csrc/cinter.cu",
        replaces="src/repro/kernels/cinter.py:86"),
    "pqscore": dict(
        lane="unfused",
        source="src/repro_torch/kernels/csrc/pqscore.cu",
        replaces="src/repro/kernels/pqscore.py:127"),
    # candidate generation, which both lanes run; it replaces no Pallas
    # kernel: the reference selects with lax.top_k
    "topnprobe": dict(
        lane="both",
        source="src/repro_torch/kernels/csrc/topnprobe.cu",
        replaces=None, selects_as="src/repro/core/bitvector.py:86"),
}


def _on_lane(kern: dict, lane: str) -> bool:
    """Whether a KERNELS entry launches on ``lane``'s retrieve."""
    return kern["lane"] in (lane, "both")


def _path_launches(name: str, pl: dict, expl: dict, distr: dict) -> dict:
    """A kernel's launches on the PLAID, explain and distributed paths
    ([B = 32, B = 1] runs; explain's all its calls), for the paths that
    launch it."""
    out = {}
    for path, rec in (("plaid", pl), ("distributed", distr)):
        got = [rec["launches"][b][name] for b in ("b32", "b1")]
        if any(got):
            out[path] = got
    if expl["launches"][name]:
        out["explain"] = expl["launches"][name]
    return out


def _plaid_form(pl: dict) -> dict:
    """cinter's whole-corpus launch on PLAID's phase 2 as a form of the
    kernels line: its plain version cannot hold the corpus' (docs, cap,
    n_q) gather, so it is timed on a sample beside the kernel."""
    c = pl["cinter"]
    return {"config": "plaid", "launches": c["launches"][0],
            "launches_b1": c["launches"][1], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "docs": c["docs"], "plain_ms": None,
            "bound_ms": c["bound"]["bound_ms"],
            "bound_by": c["bound"]["bound_by"],
            "bound_bytes": c["bound"]["bytes"], "library_ms": None,
            "sample_docs": c["sample_docs"], "ms_sample": c["ms_sample"],
            "plain_ms_sample": c["plain_ms_sample"]}


def _budget_forms(bud: dict) -> dict:
    """The cuts of any size as forms of the kernels line, from fig9's
    post-filter cases (float32, B = 32 and B = 1): the prefilter's counting
    rank and pqinter's radix select."""
    a, z = bud["fig9_b32"], bud["fig9_b1"]
    forms = {}
    for name, form in (("prefilter", "count_rank"),
                       ("pqinter", "radix_select")):
        ka, kz = a["kernels"][name], z["kernels"][name]
        forms[name] = {form: {
            "config": "budget_fig9", "launches": a["launches"]["fused"][name],
            "launches_b1": z["launches"]["fused"][name],
            "max_abs_err": ka["max_abs_err"],
            "max_abs_err_b1": kz["max_abs_err"], "ms": ka["ms"],
            "plain_ms": ka["plain_ms"], "bound": ka["bound"],
            "ms_b1": kz["ms"], "plain_ms_b1": kz["plain_ms"],
            "bound_b1": kz["bound"]}}
    return forms


def kernels_line(small_err: dict, full: dict, timing: dict,
                 prof: dict, ftiming: dict, bf16: dict, build: dict,
                 serve: dict, pl: dict, expl: dict, distr: dict,
                 enc: dict, rec: dict, lm: dict, drr: dict,
                 ex: dict, bud: dict) -> dict:
    """Phase 9: one record per kernel, from this run's measurements. Each
    kernel's launches, time and profile come from the lane that runs it on
    the main path; ``launches_by_path`` adds its launches on the trained
    index (``index_build``, B = 32 then B = 1), on the index of the
    trained encoder's embeddings (``encoder``, likewise), on MIND's item
    index with n_q = 4 (``mind_emvb``, likewise), through the service
    (``serving``), on the PLAID, explain and distributed paths
    (:func:`_path_launches`), on the LM serving path (``lm``: 0, no
    kernel of this table runs there), through the dry run's emvb-msmarco
    cells on one card (``dryrun``, serve_b32 then serve_b1) and in the
    examples' processes (``examples``, by example) and in the budgets
    phase's cases (``budgets``, by case); ``forms`` holds its filtered and
    compact operand forms, its bf16 form and its cut of any size (fig9's
    budgets), each from its own config's run, and cinter's whole-corpus
    launch on PLAID's phase 2."""
    rows = []
    bforms = _budget_forms(bud)
    for name, info in KERNELS.items():
        kforms = {**ftiming["forms"].get(name, {}),
                  **bf16["forms"].get(name, {}), **bforms.get(name, {})}
        lane = "fused" if _on_lane(info, "fused") else "unfused"
        key = "held" if lane == "fused" else "held_u"
        held_err = [h[key][b]["err"][name] for h in (full, build)
                    for b in ("b32", "b1")]
        step = "step_ms" if lane == "fused" else "unfused_step_ms"
        t32, t1 = timing["b32"], timing["b1"]
        rows.append({
            "name": name, "route": "cuda", **info,
            "launches": full["launches"][lane]["b32"][name],
            "launches_b1": full["launches"][lane]["b1"][name],
            "launches_by_path": {
                "index_build": [build["launches"][lane][b][name]
                                for b in ("b32", "b1")],
                "encoder": [enc["launches"][lane][b][name]
                            for b in ("b32", "b1")],
                "mind_emvb": [rec["launches"][lane][b][name]
                              for b in ("b32", "b1")],
                "serving": serve["launches"][name],
                **_path_launches(name, pl, expl, distr),
                "lm": lm["launches"][name],
                "dryrun": [drr["launches"][c][name]
                           for c in ("serve_b32", "serve_b1")],
                "examples": {e: ex["launches"][e][name] for e in EXAMPLES},
                "budgets": {case: bud[case]["launches"][lane][name]
                            for case in BUDGET_CASES}},
            "kernel_launches_per_call": prof[f"{lane}_b32"][
                "kernel_launches_per_wrapper_call"][name],
            "max_abs_err": max(small_err[name], *held_err),
            "ms": t32[step][f"{name}_kernel"],
            "plain_ms": t32["plain_ms"][name],
            "bound_ms": t32["bounds"][name]["bound_ms"],
            "bound_by": t32["bounds"][name]["bound_by"],
            "bound_bytes": t32["bounds"][name]["bytes"],
            "library_ms": None,
            "ms_b1": t1[step][f"{name}_kernel"],
            "plain_ms_b1": t1["plain_ms"][name],
            "bound_ms_b1": t1["bounds"][name]["bound_ms"],
            "wrapper_host_ms": t32["wrapper_host_ms"].get(name),
            "wrapper_host_ms_b1": t1["wrapper_host_ms"].get(name),
            "pass_ms": prof[f"{lane}_b32"][
                "pass_device_ms_per_wrapper_call"][name],
            "pass_ms_b1": prof[f"{lane}_b1"][
                "pass_device_ms_per_wrapper_call"][name],
            "forms": {form: {
                "config": f["config"], "launches": f["launches"],
                "launches_b1": f["launches_b1"],
                "max_abs_err": max(f["max_abs_err"], f["max_abs_err_b1"]),
                "ms": f["ms"], "plain_ms": f["plain_ms"],
                "bound_ms": f["bound"]["bound_ms"],
                "bound_by": f["bound"]["bound_by"],
                "bound_bytes": f["bound"]["bytes"], "library_ms": None,
                "ms_b1": f["ms_b1"], "plain_ms_b1": f["plain_ms_b1"],
                "bound_ms_b1": f["bound_b1"]["bound_ms"]}
                for form, f in kforms.items()},
            "ok": True,
        })
        if name == "cinter":
            rows[-1]["forms"]["plaid_corpus"] = _plaid_form(pl)
    return {"kernels": rows}


def main() -> None:
    """Run every phase in order; any failure raises."""
    _import_port()
    import torch
    dev_info = device_phase()
    dev = torch.device("cuda")
    build_phase()
    small_err = small_phase(dev)
    two_ranks = two_ranks_phase()
    rec = recsys_phase(dev)
    lm = lm_phase(dev)
    dryrun_phase(dev)
    full = full_phase(dev)
    invariance_phase(full)
    filt = filter_phase(full)
    tlres = timeline_phase(full)
    build = index_build_phase(full)
    serve = serving_phase(full, filt, tlres)
    expl = explain_phase(full, filt, tlres, serve["fingerprints"])
    distr = distributed_phase(full, tlres, serve["fingerprints"], two_ranks)
    drr = dryrun_retrieval_phase(full)
    del tlres
    pl = plaid_phase(full, build)
    for key in ("index", "queries", "gt"):
        del build[key]
    enc = encoder_phase(full)
    timing = timing_phase(full)
    ftiming = filter_timing_phase(filt)
    bf16 = bf16_phase(dev, full, filt)
    limits_phase(full)
    bud = budgets_phase(full, filt)
    prof = profile_phase(full)
    ex = examples_phase()
    line = kernels_line(small_err, full, timing, prof, ftiming, bf16,
                        build, serve, pl, expl, distr, enc, rec, lm, drr, ex,
                        bud)
    RECORD["kernels"] = line["kernels"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": dev_info}), flush=True)


if __name__ == "__main__":
    main()
