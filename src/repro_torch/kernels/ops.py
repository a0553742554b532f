"""Public kernel wrappers with the reference's signatures (counterpart of
``repro/kernels/ops.py``), minus ``interpret``: the tensors' device picks
the path. On the CPU each wrapper runs its kernel's plain PyTorch version;
on CUDA it launches the hand-written kernel or raises.

The B = 1 forms run the batched kernel with B = 1: row b of the batched
kernel is bit-identical to the single-query kernel by the reference's own
tested contract.

Every operand form of the reference is taken: the predicate filter
(``pred_words``/``plan`` in the prefilter, ``doc_pass`` in pqinter),
per-query (compact-mode) candidate codes in the prefilter and bitfilter, any
bool token mask (``prefilter.valid_first``) and any cut the reference takes
(``1 <= n_filter <= n_docs``; ``k <= n_docs <= n_filter``).
"""
from __future__ import annotations

import torch

from . import bitfilter as _bitfilter
from . import bitpack as _bitpack
from . import cinter as _cinter
from . import pqinter as _pqinter
from . import pqscore as _pqscore
from . import prefilter as _prefilter
from . import topnprobe as _topnprobe

_KERNELS = {"prefilter": _prefilter, "pqinter": _pqinter,
            "bitpack": _bitpack, "bitfilter": _bitfilter,
            "cinter": _cinter, "pqscore": _pqscore,
            "topnprobe": _topnprobe}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_launches`."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for mod in _KERNELS.values():
        mod.launches = 0


def _row(q_mask):
    return None if q_mask is None else q_mask[None]


bitpack_batched = _bitpack.bitpack_batched
bitfilter_batched = _bitfilter.bitfilter_batched
cinter_batched = _cinter.cinter_batched
pqscore_batched = _pqscore.pqscore_batched
prefilter_batched = _prefilter.prefilter_batched


def bitpack(cs: torch.Tensor, th, q_mask=None) -> torch.Tensor:
    """Bit pack for one query: cs (n_q, n_c) -> (n_c,) int32 words holding
    the reference's uint32 bits."""
    return bitpack_batched(cs[None], th, _row(q_mask))[0]


def bitfilter(bits: torch.Tensor, codes: torch.Tensor,
              token_mask: torch.Tensor) -> torch.Tensor:
    """Eq. 4 for one query: bits (n_c,), codes (docs, cap) -> F (docs,)
    int32."""
    return bitfilter_batched(bits[None], codes, token_mask)[0]


def cinter(cs_t: torch.Tensor, codes: torch.Tensor, token_mask: torch.Tensor,
           q_mask=None) -> torch.Tensor:
    """S̄ for one query: cs_t (n_c, n_q), codes (docs, cap) -> (docs,)."""
    return cinter_batched(cs_t[None], codes[None], token_mask[None],
                          _row(q_mask))[0]


def pqscore(cs_t: torch.Tensor, lut: torch.Tensor, codes: torch.Tensor,
            res_codes: torch.Tensor, token_mask: torch.Tensor, th_r,
            q_mask=None) -> torch.Tensor:
    """Eq. 5/6 scores for one query: cs_t (n_c, n_q), lut (n_q, m, K),
    codes (docs, cap), res_codes (docs, cap, m) uint8 -> (docs,)."""
    return pqscore_batched(cs_t[None], lut[None], codes[None],
                           res_codes[None], token_mask[None], th_r,
                           _row(q_mask))[0]


def prefilter(cs: torch.Tensor, th, codes: torch.Tensor,
              token_mask: torch.Tensor, bitmap: torch.Tensor, n_filter: int,
              q_mask=None, *, pred_words=None, plan=None):
    """Fused phases 1b-2 for one query -> (scores (n_filter,),
    doc_ids (n_filter,), bits (n_c,)); codes (n_docs, cap), the plan as in
    the batched form."""
    out = prefilter_batched(cs[None], th, codes, token_mask, bitmap[None],
                            n_filter, _row(q_mask),
                            pred_words=pred_words, plan=plan)
    return tuple(x[0] for x in out)


def pqinter_batched(cs_t: torch.Tensor, lut: torch.Tensor,
                    codes: torch.Tensor, res_codes: torch.Tensor,
                    token_mask: torch.Tensor, th_r, n_docs: int, k: int,
                    q_masks=None, *, doc_pass=None):
    """Batch-native phases 3-4 megakernel -> (scores, pos, sel2, sbar),
    each with a leading batch axis; ``doc_pass`` (B, n_filter) bool."""
    return _pqinter.pqinter_batched(cs_t, lut, codes, res_codes, token_mask,
                                    th_r, n_docs, k, q_masks, doc_pass)


def pqinter(cs_t: torch.Tensor, lut: torch.Tensor, codes: torch.Tensor,
            res_codes: torch.Tensor, token_mask: torch.Tensor, th_r,
            n_docs: int, k: int, q_mask=None, *, doc_pass=None):
    """Fused phases 3-4 for one query -> (scores (k,), pos (k,),
    sel2 (n_docs,), sbar (n_docs,))."""
    out = pqinter_batched(cs_t[None], lut[None], codes[None], res_codes[None],
                          token_mask[None], th_r, n_docs, k, _row(q_mask),
                          doc_pass=_row(doc_pass))
    return tuple(x[0] for x in out)
