"""The least time the chip could take for a kernel's work on these inputs:
the larger of its bytes over the HBM rate and its operations over the
float32 rate, from the published peaks of one NVIDIA H100 SXM (data sheet,
700 W: 3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores).

The byte and operation counts are frozen copies of ``chip_smoke.py``'s
``prefilter_bound`` (lines 851-873), ``pqinter_bound`` (lines 904-934) and
``_bound`` (lines 1017-1023), fed with the counts the reference reports
(``references/emvb.py``, ``counts=True``), so a share reads the same work
whatever implements it. One change to ``pqinter_bound``: the winners'
residual bytes and LUT adds count only what Eq. 6 needs on these inputs.
A term that keeps some token (CS above th_r) needs those tokens' residuals
and adds; a term that keeps none falls back to every valid token of the
doc. The copy counted every winner's token for every term, so a kernel
that skips the residuals Eq. 6 ignores would read above 100 %.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes: int, n_ops: int) -> dict:
    """-> {bytes, ops, bound_ms, bound_by}."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def prefilter_bound(c: dict) -> dict:
    """Least bytes the prefilter must move on one batch: the CS, the
    candidate bitmap, the term mask, the lengths and valid-token codes of
    every doc that is some query's candidate, and its outputs (top
    n_filter scores and ids, the bit words). Under a filter: the predicate
    word of every doc that is some query's candidate, and codes only of
    those that pass. One compare per CS entry and one word OR per (query,
    candidate token)."""
    nb, n_q, n_c = c["batch"], c["n_q"], c["n_c"]
    nbytes = (nb * n_q * n_c * c["cs_bytes"] + nb * c["n_docs"] + nb * n_q
              + c["words_docs"] * 4
              + c["cand_docs"] * 4 + c["cand_tokens"] * 4
              + nb * c["n_filter"] * 8 + nb * n_c * 4)
    return bound(nbytes, nb * n_q * n_c + nb * c["cand_tokens"])


def pqinter_bound(c: dict) -> dict:
    """Least bytes the phases 3-4 kernel must move on one batch: the
    survivors' valid-token codes and lengths, the CS^T rows those tokens
    touch, the LUT, the residual codes Eq. 6 needs of the winners, the term
    mask, the outputs; under a filter the survivors' verdicts, and tokens
    only of passing survivors. One max per (survivor token, term), and m
    LUT adds and a max per (winner token, term) that Eq. 6 scores."""
    nb, n_q, m = c["batch"], c["n_q"], c["m"]
    verdicts = nb * c["n_filter"] if c["filtered"] else 0
    nbytes = (c["survivor_tokens"] * 4 + nb * c["n_filter"] * 4
              + c["rows_touched"] * n_q * c["cs_bytes"]
              + nb * n_q * m * c["ksub"] * 4
              + c["eq6_tokens"] * m + nb * n_q + nb * c["k"] * 8
              + nb * c["n_docs"] * 8 + verdicts)
    ops = c["survivor_tokens"] * n_q + c["eq6_pairs"] * (m + 1)
    return bound(nbytes, ops)


BOUNDS = {"prefilter": prefilter_bound, "pqinter": pqinter_bound}
