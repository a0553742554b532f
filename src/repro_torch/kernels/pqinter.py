"""Fused phases 3-4 (S̄, top-n_docs, Eq. 5/6 PQ scores, top-k) for a
micro-batch over each query's phase-2 survivors.

Replaces ``repro/kernels/pqinter.py::pqinter_batched`` (Pallas body
``_pqinter_batched_kernel``, :256, inlining ``cinter.py::sbar_block_batched``
and ``pqscore.py::eq56_block_batched``) and, at B = 1, ``pqinter``
(``_pqinter_kernel``, :87). The CUDA kernel is ``csrc/pqinter.cu``; its
source note says what bounds it on the H100 and how the design answers.
Its Eq. 5/6 pass holds each query's LUT in the shared memory of a
thread-block cluster, in the term-group-major layout :func:`flat_lut`
makes; :func:`eq56_plan` reports how a launch runs it.
:func:`pqinter_batched_ref` is its plain PyTorch version.

Both cuts match the reference's running merges exactly: phase 3 keeps the
top ``n_docs`` survivors by (S̄ desc, survivor position asc), phase 4 the
top ``k`` of those by (score desc, phase-3 rank asc). The kernel takes any
``k <= n_docs <= n_filter``: a cut of up to 4,096 keys runs in shared
memory, a larger one as a radix select over global scratch
(``csrc/common.cuh``).

With ``doc_pass`` (B, n_filter), the predicate verdict per survivor, a
failing survivor is -inf in both cuts, and the fillers are the reference's:
when fewer than ``n_docs`` survivors pass, the phase-3 cut ends in
(position -1, S̄ -inf) slots; when fewer than ``k`` pass, the final cut ends
in (score -inf, position 0) slots.

:func:`pqinter_batched` dispatches on the tensors' device: on the CPU it
runs the plain version; on CUDA it launches the kernel (and counts the launch
in ``launches``) or raises — it never falls back.

CS^T is float32 or bf16; the LUT is float32. On bf16, as in the reference
(``pqinter.py:115-118``, ``:279``), S̄ is the bf16 sum widened exactly to
float32 for the phase-3 cut (bf16 ties are frequent; the cut's (S̄,
position) keys break them), and Eq. 5/6 is pqscore's (``th_r`` rounded
through float32 to bf16).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.interaction import centroid_interaction, late_interaction_pq
from ..core.precision import CS_TYPES, kernel_th, round_to
from ..core.topk import topk
from . import _build, _meta
from .prefilter import valid_first

launches = 0      # kernel launches since the last reset


def _rows(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """x (B, nf, ...) gathered at sel (B, n) along axis 1."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, sel]


def pqinter_batched_ref(cs_t: torch.Tensor, lut: torch.Tensor,
                        codes: torch.Tensor, res_codes: torch.Tensor,
                        lens: torch.Tensor, th_r, n_docs: int, k: int,
                        q_masks=None, doc_pass=None):
    """Plain PyTorch version of the kernel, built on ``core``.
    -> (scores (B, k) f32, pos (B, k) i32, sel2 (B, n_docs) i32,
        sbar (B, n_docs) f32)"""
    cap = codes.shape[-1]
    valid = torch.arange(cap, device=codes.device) < lens[..., None]
    sbar_all = centroid_interaction(cs_t, codes, valid,
                                    q_masks).float()          # (B, nf)
    if doc_pass is not None:
        sbar_all = torch.where(doc_pass, sbar_all,
                               torch.full_like(sbar_all, -torch.inf))
    sbar, sel2 = topk(sbar_all, n_docs)
    if doc_pass is not None:
        filler = ~torch.gather(doc_pass, 1, sel2)
        sel2 = torch.where(filler, -1, sel2)
        sbar = torch.where(filler, -torch.inf, sbar)
    rows = torch.clamp(sel2, min=0)
    score = late_interaction_pq(cs_t, lut, _rows(codes, rows),
                                _rows(res_codes, rows), _rows(valid, rows),
                                kernel_th(th_r), q_mask=q_masks)   # (B, nd)
    if doc_pass is not None:
        score = torch.where(filler, -torch.inf, score)
    scores, rank = topk(score, k)
    pos = torch.gather(sel2, 1, rank)
    if doc_pass is not None:
        pos = torch.where(scores == -torch.inf, 0, pos)
    return scores, pos.to(torch.int32), sel2.to(torch.int32), sbar


def lut_rows(mk: int, terms: int) -> int:
    """Rows of a group of :func:`flat_lut`'s layout: m*K, padded for the
    cluster pass's T = 1 and 2 so that a group is a whole number of 16-byte
    pieces (``csrc/doc_math.cuh``'s ``e56_rows``)."""
    q = 1 if terms >= 4 else 4 // terms
    return -(-mk // q) * q


def flat_lut(lut: torch.Tensor, terms: int) -> torch.Tensor:
    """(B, n_q, m, K) -> the term-group-major (B, G, rows, terms) table the
    Eq. 5/6 kernels read: G = ceil(n_q / terms) groups of ``terms`` terms,
    ``lut[b, i, s, k]`` at ``[b, i // terms, s * K + k, i % terms]``; the
    last group's missing terms and the rows past m*K are 0. The cluster pass
    stages one group a CTA; the L2 form reads one group of all n_q terms."""
    nb, n_q, m, ksub = lut.shape
    groups, rows = -(-n_q // terms), lut_rows(m * ksub, terms)
    flat = lut.reshape(nb, n_q, m * ksub)
    if groups * terms != n_q or rows != m * ksub:   # pad with zeros
        flat = flat.new_zeros((nb, groups * terms, rows))
        flat[:, :n_q, :m * ksub] = lut.reshape(nb, n_q, m * ksub)
    return flat.view(nb, groups, terms, rows).transpose(2, 3).contiguous()


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "pqinter_scratch_bytes": (ctypes.c_size_t, [_CI, _CI, _CI, _CI]),
    "pqinter_batched": (_CI, [_VP, _CI, _VP, _CI, _VP, _VP, _VP, _VP, _VP,
                              _CI, _CI, _CI, _CI, _CI, _CI, _CI,
                              ctypes.c_float, _CI, _CI, _CI, _VP, _VP, _VP,
                              _VP, _VP, _VP]),
}
PLAN_FIELDS = ("cluster_form", "terms", "groups", "cluster", "passes", "rows",
               "runs", "clusters", "smem", "staged_bytes")


def _fn(name: str):
    return _build.function("pqinter", name, *_SIGNATURES[name])


@functools.lru_cache(maxsize=None)
def lut_terms(lib: str, n_q: int, m: int, ksub: int) -> int:
    """The terms a group of the LUT layout the Eq. 5/6 pass of ``lib``
    (pqinter or pqscore) reads at this shape on the current card."""
    return _build.function(lib, f"{lib}_lut_terms", _CI,
                           [_CI, _CI, _CI])(n_q, m, ksub)


def eq56_plan(lib: str, fn: str, cs_t, res_codes, n_docs: int, n_q: int,
              m: int, ksub: int, runs: int = 0) -> dict:
    """The plan of the Eq. 5/6 pass (``csrc/doc_math.cuh``'s
    ``eq56_plan``) that ``lib``'s C entry ``fn`` reports for these CUDA
    operands over B = ``res_codes.shape[0]`` queries' ``n_docs`` docs: its
    form (``cluster`` or ``L2``), T, groups, cluster size, passes, runs a
    query, clusters, shared bytes a CTA, the LUT bytes it stages, docs a
    run."""
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    err = _build.function(lib, fn, _CI, [_CI, _VP, _CI, _CI, _CI, _CI, _CI,
                                         _CI, _VP])(
        _build.cs_flag(cs_t), _build.ptr(res_codes), res_codes.shape[0],
        n_docs, n_q, m, ksub, runs, ctypes.cast(out, _VP))
    _build.check(err, fn)
    plan = dict(zip(PLAN_FIELDS, (int(v) for v in out)))
    plan["form"] = "cluster" if plan.pop("cluster_form") else "L2"
    plan["docs_per_run"] = -(-n_docs // plan["runs"]) if plan["runs"] else 0
    return plan


def _launch(cs_t, lut2, terms, codes, res_codes, lens, qm, doc_pass, th_r,
            n_docs, k, m, ksub):
    """One launch of ``csrc/pqinter.cu`` on lut2, the LUT in flat_lut's
    layout of ``terms``; qm None means every term is live, doc_pass None
    that every survivor passes."""
    global launches
    nb, nf, cap = codes.shape
    n_c, n_q = cs_t.shape[1:]
    dev = cs_t.device
    # scores | pos | sel2 | sbar, each contiguous, in one int32 allocation
    out = torch.empty(nb * (2 * k + 2 * n_docs), dtype=torch.int32,
                      device=dev)
    scores, pos, sel2, sbar = (x.view(nb, -1) for x in out.split(
        (nb * k, nb * k, nb * n_docs, nb * n_docs)))
    scores, sbar = scores.view(torch.float32), sbar.view(torch.float32)
    scratch = torch.empty(_fn("pqinter_scratch_bytes")(nb, nf, n_docs, k),
                          dtype=torch.uint8, device=dev)
    p = _build.ptr
    err = _fn("pqinter_batched")(
        p(cs_t), _build.cs_flag(cs_t), p(lut2), terms, p(codes),
        p(res_codes), p(lens), p(qm), p(doc_pass), nb, nf, cap, n_c, n_q, m,
        ksub, 0.0 if th_r is None else round_to(th_r, cs_t.dtype),
        int(th_r is not None), n_docs, k, p(scores), p(pos), p(sel2),
        p(sbar), p(scratch), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pqinter_batched")
    launches += 1
    return scores, pos, sel2, sbar


def _meta_outputs(cs_t, lut, codes, n_docs: int, k: int, doc_pass):
    """The kernel's outputs on meta and its bound's bytes, dense (every
    survivor's tokens valid, every touched CS^T row distinct;
    ``kernels/_meta.py``)."""
    nb, nf, cap = codes.shape
    n_c, n_q = cs_t.shape[1:]
    m = lut.shape[2]
    tokens, win_tokens = nb * nf * cap, nb * n_docs * cap
    rows = _meta.rows_touched(nb, n_c, tokens)
    _meta.account("pqinter",
                  tokens * 4 + nb * nf * 4 + rows * n_q * cs_t.element_size()
                  + _meta.nbytes(lut) + win_tokens * m + nb * n_q
                  + nb * k * 8 + nb * n_docs * 8
                  + (nb * nf if doc_pass is not None else 0),
                  tokens * n_q + win_tokens * n_q * (m + 1))
    return (_meta.empty((nb, k), torch.float32),
            _meta.empty((nb, k), torch.int32),
            _meta.empty((nb, n_docs), torch.int32),
            _meta.empty((nb, n_docs), torch.float32))


def pqinter_batched(cs_t: torch.Tensor, lut: torch.Tensor,
                    codes: torch.Tensor, res_codes: torch.Tensor,
                    token_mask: torch.Tensor, th_r, n_docs: int, k: int,
                    q_masks=None, doc_pass=None):
    """Batch-native fused phases 3-4.

    cs_t (B, n_c, n_q <= 32) float32 or bf16; lut (B, n_q, m, K) float32; codes
    (B, n_filter, cap) int32; res_codes (B, n_filter, cap, m) uint8;
    token_mask (B, n_filter, cap) bool mask (any:
    ``prefilter.valid_first``) or (B, n_filter) int32 lengths; th_r None (Eq. 5) or a float (Eq. 6); q_masks optional
    (B, n_q) bool; doc_pass optional (B, n_filter) bool.
    -> (scores (B, k) f32, pos (B, k) i32, sel2 (B, n_docs) i32,
        sbar (B, n_docs) f32); ``pos``/``sel2`` index the survivor axis.
    """
    nb, nf, cap = codes.shape
    n_q, m, ksub = lut.shape[1:]
    if not k <= n_docs <= nf:
        raise ValueError(f"need k <= n_docs <= n_filter, got {k}/{n_docs}/"
                         f"{nf}")
    if cs_t.shape[-1] != n_q or n_q > 32:
        raise ValueError(f"cs_t {tuple(cs_t.shape)} and lut "
                         f"{tuple(lut.shape)} disagree on n_q (<= 32)")
    lens, codes, res_codes = valid_first(token_mask, codes,
                                         res_codes)
    if tuple(lens.shape) != (nb, nf):
        raise ValueError(f"token validity covers {tuple(lens.shape)}, "
                         f"expected {(nb, nf)}")
    if doc_pass is not None and tuple(doc_pass.shape) != (nb, nf):
        raise ValueError(f"doc_pass is {tuple(doc_pass.shape)}, expected "
                         f"{(nb, nf)}")
    if cs_t.is_meta:
        return _meta_outputs(cs_t, lut, codes, n_docs, k, doc_pass)
    if cs_t.device.type == "cpu":
        return pqinter_batched_ref(cs_t, lut, codes, res_codes, lens, th_r,
                                   n_docs, k, q_masks, doc_pass)
    if cs_t.device.type != "cuda":
        raise ValueError(f"pqinter: unsupported device {cs_t.device}")
    terms = lut_terms("pqinter", n_q, m, ksub)
    lut2 = flat_lut(lut, terms)
    n_c = cs_t.shape[1]
    operands = [("cs_t", cs_t, CS_TYPES, (nb, n_c, n_q)),
                ("lut", lut2, torch.float32, (nb, -(-n_q // terms),
                                              lut_rows(m * ksub, terms),
                                              terms)),
                ("codes", codes, torch.int32, (nb, nf, cap)),
                ("res_codes", res_codes, torch.uint8, (nb, nf, cap, m)),
                ("token lengths", lens, torch.int32, (nb, nf))]
    if q_masks is not None:
        operands.append(("q_masks", q_masks, torch.bool, (nb, n_q)))
    if doc_pass is not None:
        operands.append(("doc_pass", doc_pass, torch.bool, (nb, nf)))
    _build.check_operands("pqinter", cs_t.device, operands)
    return _launch(cs_t, lut2, terms, codes, res_codes, lens, q_masks,
                   doc_pass, th_r, n_docs, k, m, ksub)
