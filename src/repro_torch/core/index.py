"""The packed retrieval index as PyTorch tensors (counterpart of
``repro/core/index.py``).

Same layout as the reference: documents padded to ``cap`` tokens with the
one-past-end centroid id ``n_c`` as pad, true lengths in ``doc_lens``, and a
padded ``(n_c, list_cap)`` inverted file whose pad is the doc id ``n_docs``.

The build lives here too: :func:`build_index` trains the centroid
vocabulary, the PQ (or OPQ) codebooks and the PLAID codec, then quantizes
every token against them, pools documents to a budget when asked, and lays
out the IVF. Its trained parts draw from a ``torch.Generator`` where the
reference draws from ``jax.random``, so a build equals the reference's in
its deterministic fields and in retrieval quality, not to the bit.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .bitvector import PredicateSet
from .kmeans import Seed, assign, kmeans_spherical, split
from .pq import PQCodebooks, encode_pq, train_opq, train_pq
from .precision import exact_matmuls
from .residual import ResidualCodec, encode_residual, train_residual_codec

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
    def plaid_codec(self) -> ResidualCodec:
        """The PLAID b-bit residual codec reconstructed from its arrays."""
        nb = self.plaid_weights.shape[0]
        return ResidualCodec(self.plaid_cutoffs, self.plaid_weights,
                             int(np.log2(nb)))

    @property
    def device(self) -> torch.device:
        """The device every field lives on."""
        return self.codes.device

    def token_mask(self) -> torch.Tensor:
        """(n_docs, cap) bool — True for real (non-padding) tokens."""
        cap = self.codes.shape[1]
        return (torch.arange(cap, device=self.codes.device)[None, :]
                < self.doc_lens[:, None])


def bytes_per_embedding(meta: IndexMeta, method: str) -> float:
    """Paper Table 1 'Bytes' column (ref ``index.py:137``): the centroid id
    at a machine width (1/2/4 bytes) plus the residual code bytes."""
    bits = int(np.ceil(np.log2(meta.n_centroids)))
    cid = 1 if bits <= 8 else 2 if bits <= 16 else 4
    if method == "emvb":
        return cid + meta.m * meta.nbits / 8
    if method == "plaid":
        return cid + meta.d * meta.plaid_b / 8
    raise ValueError(method)


def normalized_tokens(doc_embs: np.ndarray) -> np.ndarray:
    """Every token row re-normalized on the host with numpy exactly as the
    reference does it (``index.py:150``), so the same inputs give the same
    float32 bits: (n_docs, cap, d) -> (n_docs*cap, d) float32, zero padding
    rows staying zero."""
    normed = np.asarray(doc_embs, dtype=np.float32)
    norms = np.maximum(np.linalg.norm(normed, axis=-1, keepdims=True), 1e-12)
    return (normed / norms).reshape(-1, normed.shape[-1])


def quantize_tokens(centroids: torch.Tensor, doc_embs: np.ndarray,
                    doc_lens: np.ndarray
                    ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Assign every token to its nearest frozen centroid (ref
    ``index.py:150``), on the centroids' device.

    The rows are re-normalized by :func:`normalized_tokens`; the
    assignment is :func:`~.kmeans.assign` (equal to the reference's except
    at near-ties, see ``kmeans``). Padding rows (all zero) are assigned
    too, and their residuals feed the residual codes as in the reference.

    centroids : (n_c, d) float32
    doc_embs  : (n_docs, cap, d) float32, zero-padded
    doc_lens  : (n_docs,) int
    -> (codes (n_docs, cap) int32 with the ``n_c`` pad sentinel,
        residual_flat (n_docs*cap, d) float32 token - centroid residuals,
        mask (n_docs, cap) bool of real tokens, a numpy array)
    """
    n_docs, cap, _ = doc_embs.shape
    n_centroids = centroids.shape[0]
    mask = (np.arange(cap)[None, :] < np.asarray(doc_lens)[:, None])
    flat = torch.from_numpy(normalized_tokens(doc_embs)).to(centroids.device)
    codes_flat = assign(flat, centroids)
    residual_flat = flat - centroids[codes_flat.long()]
    codes = codes_flat.reshape(n_docs, cap)
    pad = torch.from_numpy(~mask).to(centroids.device)
    codes = torch.where(pad, n_centroids, codes).to(torch.int32)
    return codes, residual_flat, mask


def pool_documents(doc_embs: np.ndarray, doc_lens: np.ndarray,
                   budget: int, *, iters: int = 4
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Pool every document down to at most ``budget`` vectors (ref
    ``index.py:182``; arXiv 2504.01818), in numpy on the host as the
    reference does it.

    Documents with ``len <= budget`` pass through unchanged. Longer docs
    are clustered with a per-doc deterministic spherical k-means (evenly
    spaced token indices as seeds, no RNG), then each cluster is
    mean-pooled over its raw token vectors; empty clusters are dropped.

    doc_embs : (n_docs, cap, d) float32, zero-padded
    doc_lens : (n_docs,) int
    -> (pooled_embs (n_docs, min(cap, budget), d) float32 zero-padded,
        pooled_lens (n_docs,) int32)
    """
    if budget < 1:
        raise ValueError(f"doc_budget must be >= 1, got {budget}")
    doc_embs = np.asarray(doc_embs, dtype=np.float32)
    doc_lens = np.asarray(doc_lens)
    n_docs, cap, d = doc_embs.shape
    new_cap = min(cap, int(budget))
    out = np.zeros((n_docs, new_cap, d), np.float32)
    out_lens = np.zeros((n_docs,), np.int32)
    for i in range(n_docs):
        ln = int(doc_lens[i])
        toks = doc_embs[i, :ln]
        if ln <= budget:
            out[i, :ln] = toks
            out_lens[i] = ln
            continue
        normed = toks / np.maximum(
            np.linalg.norm(toks, axis=-1, keepdims=True), 1e-12)
        # evenly spaced seeds, distinct because ln > budget
        seed_idx = np.round(np.linspace(0, ln - 1, budget)).astype(int)
        cents = normed[seed_idx]
        labels = np.argmax(normed @ cents.T, axis=1)
        for _ in range(iters):
            sums = np.zeros((budget, d), np.float32)
            np.add.at(sums, labels, normed)
            counts = np.bincount(labels, minlength=budget)
            means = sums / np.maximum(counts, 1)[:, None]
            means /= np.maximum(
                np.linalg.norm(means, axis=-1, keepdims=True), 1e-12)
            # empty clusters keep their previous centroid
            cents = np.where((counts > 0)[:, None], means, cents)
            labels = np.argmax(normed @ cents.T, axis=1)
        sums = np.zeros((budget, d), np.float32)
        np.add.at(sums, labels, toks)          # mean over RAW token vectors
        counts = np.bincount(labels, minlength=budget)
        keep = counts > 0
        pooled = sums[keep] / counts[keep][:, None]
        out[i, :pooled.shape[0]] = pooled
        out_lens[i] = pooled.shape[0]
    return out, out_lens


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


@exact_matmuls()
def build_index(seed: Seed, doc_embs: np.ndarray, doc_lens: np.ndarray, *,
                n_centroids: int, m: int = 16, nbits: int = 8,
                plaid_b: int = 2, list_cap: Optional[int] = None,
                kmeans_iters: int = 8, pq_train_size: int = 65536,
                use_opq: bool = False, predicates=None,
                doc_budget: Optional[int] = None, device=None
                ) -> tuple[PackedIndex, IndexMeta]:
    """Build the full EMVB/PLAID index over a padded corpus (ref
    ``index.py:293``) on ``resolve_device(device)``: the GPU unless the
    caller asks for the CPU.

    Spherical k-means over every real token builds the centroid vocabulary
    (paper §4.1); every token is assigned (:func:`quantize_tokens`); PQ
    codebooks (OPQ with ``use_opq``) are trained on a sample of at most
    ``pq_train_size`` real residuals, the rows numpy's
    ``default_rng(0).choice`` picks as in the reference, and encode every
    residual (§4.4); the PLAID b-bit codec is fitted on the same sample;
    the IVF is laid out by :func:`build_ivf` (``list_cap=None`` sizes it to
    the longest list, a given one warns when it drops entries).
    ``train_quant_mse``, the drift baseline, is the mean squared real
    residual, computed in numpy in the reference's order.

    ``seed`` (an int or a ``torch.Generator``) gives the k-means and the
    PQ/OPQ training a generator each. ``predicates`` (a
    :class:`~.bitvector.PredicateSet` or ``{name: (n_docs,) bool}``)
    attaches the predicate plane; ``doc_budget`` pools every document to at
    most that many vectors first (:func:`pool_documents`).

    doc_embs : (n_docs, cap, d) float32, zero-padded
    doc_lens : (n_docs,) int
    -> (PackedIndex on the device, IndexMeta)
    """
    dev = resolve_device(device)
    n_raw_tokens = int(np.asarray(doc_lens).sum())
    if doc_budget is not None:
        doc_embs, doc_lens = pool_documents(doc_embs, doc_lens, doc_budget)
    doc_embs = np.asarray(doc_embs, dtype=np.float32)
    doc_lens = np.asarray(doc_lens)
    n_docs, cap, d = doc_embs.shape
    g_centroids, g_pq = split(seed, 2)

    if predicates is None:
        pred_names: tuple = ()
        pred_words = torch.zeros(n_docs, dtype=torch.uint32)
    else:
        pset = (predicates if isinstance(predicates, PredicateSet)
                else PredicateSet.pack(predicates))
        if pset.words.shape[0] != n_docs:
            raise ValueError(
                f"predicate plane covers {pset.words.shape[0]} docs but the "
                f"corpus has {n_docs}: predicates must be given for every "
                "doc at build time")
        pred_names = pset.names
        pred_words = pset.words

    mask = np.arange(cap)[None, :] < doc_lens[:, None]
    flat = torch.from_numpy(doc_embs.reshape(-1, d)[mask.reshape(-1)]).to(dev)
    flat = flat / torch.clamp(torch.linalg.norm(flat, dim=-1, keepdim=True),
                              min=1e-12)
    centroids, _ = kmeans_spherical(g_centroids, flat, n_centroids,
                                    iters=kmeans_iters, device=dev)
    del flat

    codes, residual_flat, mask = quantize_tokens(centroids, doc_embs,
                                                 doc_lens)
    real = torch.from_numpy(mask.reshape(-1)).to(dev)
    real_res = residual_flat[real]
    n_real = real_res.shape[0]
    pick = np.random.default_rng(0).choice(
        n_real, size=min(pq_train_size, n_real), replace=False)
    res_sample = real_res[torch.from_numpy(pick).to(dev)]
    if use_opq:
        opq = train_opq(g_pq, res_sample, m, nbits=nbits, device=dev)
        rotation, pq_cb = opq.rotation, opq.cb
        residual_rot = residual_flat @ rotation
    else:
        rotation = torch.eye(d, dtype=torch.float32, device=dev)
        pq_cb = train_pq(g_pq, res_sample, m, nbits=nbits, device=dev)
        residual_rot = residual_flat
    res_codes = encode_pq(residual_rot, pq_cb).reshape(n_docs, cap, m)
    del residual_rot

    codec = train_residual_codec(res_sample, plaid_b)
    plaid_res = encode_residual(residual_flat, codec).reshape(n_docs, cap,
                                                              -1)
    del residual_flat

    ivf, ivf_lens, list_cap, n_dropped = build_ivf(
        codes, n_centroids, list_cap, origin="build_index")

    host_res = real_res.cpu().numpy()
    train_quant_mse = float(np.mean(np.sum(host_res * host_res, axis=-1)))

    meta = IndexMeta(n_docs=n_docs, n_centroids=n_centroids, d=d, cap=cap,
                     m=m, nbits=nbits, plaid_b=plaid_b, list_cap=list_cap,
                     n_dropped=n_dropped, train_quant_mse=train_quant_mse,
                     pred_names=pred_names, doc_budget=doc_budget,
                     n_raw_tokens=n_raw_tokens)
    index = PackedIndex(
        centroids=centroids, codes=codes,
        doc_lens=torch.from_numpy(doc_lens.astype(np.int32)).to(dev),
        res_codes=res_codes, pq_codebooks=pq_cb.codebooks, ivf=ivf,
        ivf_lens=ivf_lens, plaid_res=plaid_res,
        plaid_cutoffs=codec.cutoffs, plaid_weights=codec.bucket_weights,
        opq_rotation=rotation, pred_words=pred_words.to(dev))
    return index, meta
