"""The packed retrieval index as PyTorch tensors (counterpart of
``repro/core/index.py``).

Same layout as the reference: documents padded to ``cap`` tokens with the
one-past-end centroid id ``n_c`` as pad, true lengths in ``doc_lens``, and a
padded ``(n_c, list_cap)`` inverted file whose pad is the doc id ``n_docs``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .pq import PQCodebooks

IVF_BLOCK_DOCS = 1 << 20   # docs per step of build_ivf's pair dedup


@dataclasses.dataclass(frozen=True)
class IndexMeta:
    """Static description of a :class:`PackedIndex` (shapes + build params);
    the same fields, defaults and JSON form as the reference's ``IndexMeta``
    (``repro/core/index.py:29``)."""

    n_docs: int
    n_centroids: int
    d: int
    cap: int
    m: int
    nbits: int
    plaid_b: int
    list_cap: int
    n_dropped: int = 0
    n_grown: int = 0
    train_quant_mse: float = 0.0
    grown_quant_mse: float = 0.0
    pred_names: tuple = ()
    doc_budget: Optional[int] = None
    n_raw_tokens: int = 0

    @property
    def drift(self) -> float:
        """Quantization-drift ratio ``grown_quant_mse / train_quant_mse``
        (1.0 when nothing was grown)."""
        if self.n_grown == 0 or self.train_quant_mse == 0.0:
            return 1.0
        return self.grown_quant_mse / self.train_quant_mse


class PackedIndex(NamedTuple):
    """The complete on-device retrieval index: the reference's 12 fields, as
    tensors of the same dtypes (``pred_words`` is ``torch.uint32``)."""

    centroids: torch.Tensor      # (n_c, d) fp32, L2-normalized
    codes: torch.Tensor          # (n_docs, cap) int32, pad = n_c
    doc_lens: torch.Tensor       # (n_docs,) int32
    res_codes: torch.Tensor      # (n_docs, cap, m) uint8 PQ codes
    pq_codebooks: torch.Tensor   # (m, K, dsub) fp32
    ivf: torch.Tensor            # (n_c, list_cap) int32, pad = n_docs
    ivf_lens: torch.Tensor       # (n_c,) int32
    plaid_res: torch.Tensor      # (n_docs, cap, d*b//8) uint8 (PLAID)
    plaid_cutoffs: torch.Tensor
    plaid_weights: torch.Tensor
    opq_rotation: torch.Tensor   # (d, d); identity when OPQ is off
    pred_words: torch.Tensor     # (n_docs,) uint32 predicate plane

    @property
    def pq(self) -> PQCodebooks:
        """PQ codebooks wrapped in their NamedTuple view."""
        return PQCodebooks(self.pq_codebooks)

    @property
    def device(self) -> torch.device:
        """The device every field lives on."""
        return self.codes.device

    def token_mask(self) -> torch.Tensor:
        """(n_docs, cap) bool — True for real (non-padding) tokens."""
        cap = self.codes.shape[1]
        return (torch.arange(cap, device=self.codes.device)[None, :]
                < self.doc_lens[:, None])


def index_from_arrays(arrays: dict, device=None) -> PackedIndex:
    """Build the port's index from one numpy array per ``PackedIndex`` field
    (e.g. ``{f: np.asarray(getattr(ref_index, f)) for f in fields}``). Every
    field keeps its dtype and bytes; the tensors land on ``device`` (CUDA
    unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    missing = sorted(set(PackedIndex._fields) - set(arrays))
    if missing:
        raise ValueError(f"index_from_arrays: missing field(s) {missing}")

    def tensor(a):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:      # e.g. a view of a jax array
            a = a.copy()
        return torch.from_numpy(a).to(dev)

    return PackedIndex(**{f: tensor(arrays[f]) for f in PackedIndex._fields})


def build_ivf(codes: torch.Tensor, n_centroids: int,
              list_cap: Optional[int], *, origin: str = "build_index"
              ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """Padded ``(n_c, list_cap)`` inverted file from sentinel-padded token
    codes, on the codes' device — the reference ``_build_ivf``
    (``repro/core/index.py:247``) layout exactly: each list holds the sorted
    unique ids of the docs with a token on that centroid, truncated at
    ``list_cap`` (``None`` sizes it to ``max(8, longest list)``) and padded
    with ``n_docs``. Returns ``(ivf, ivf_lens, list_cap, n_dropped)`` and
    warns when lists were truncated."""
    dev = codes.device
    n_docs, cap = codes.shape
    valid = codes < n_centroids
    doc_of_token = torch.arange(n_docs, device=dev,
                                dtype=torch.int64)[:, None].expand(n_docs, cap)
    # one int64 key per (centroid, doc) pair: sorted unique keys run by
    # centroid, then by doc id inside each list. Dedup per block of docs
    # (keys of different docs never collide), then sort the concatenation.
    parts = []
    for s in range(0, n_docs, IVF_BLOCK_DOCS):
        v = valid[s:s + IVF_BLOCK_DOCS]
        parts.append(torch.unique(
            codes[s:s + IVF_BLOCK_DOCS][v].to(torch.int64) * n_docs
            + doc_of_token[s:s + IVF_BLOCK_DOCS][v]))
    keys = torch.sort(torch.cat(parts)).values
    del parts
    cid = keys // n_docs
    doc = (keys - cid * n_docs).to(torch.int32)
    del keys
    full_lens = torch.bincount(cid, minlength=n_centroids)
    max_len = int(full_lens.max()) if full_lens.numel() else 0
    if list_cap is None:
        list_cap = max(8, max_len)
    starts = torch.cumsum(full_lens, 0) - full_lens
    rank = torch.arange(cid.numel(), device=dev) - starts[cid]
    keep = rank < list_cap
    ivf = torch.full((n_centroids, list_cap), n_docs, dtype=torch.int32,
                     device=dev)
    ivf[cid[keep], rank[keep]] = doc[keep]
    ivf_lens = torch.clamp(full_lens, max=list_cap).to(torch.int32)
    over = full_lens - ivf_lens
    n_dropped = int(over.sum())
    if n_dropped:
        warnings.warn(
            f"{origin}: {int((over > 0).sum())} IVF list(s) overflowed "
            f"list_cap={list_cap}; {n_dropped} doc-id entries dropped "
            f"(longest list: {max_len}). Dropped docs are unreachable "
            "through the overflowed centroids in phase 1 — raise list_cap "
            "(or leave it None to auto-size) if recall matters.",
            stacklevel=2)
    return ivf, ivf_lens, list_cap, n_dropped
