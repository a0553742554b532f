"""Index lifecycle (counterpart of ``repro/core/store.py``): persistence,
growth against frozen codebooks, and multi-generation timelines.

* **Persistence.** :func:`save_index` / :func:`load_index` write and read the
  reference's on-disk format, ``manifest.json`` + ``arrays.npz`` (schema v4
  with its v1-v3 fallbacks on read), byte for byte: a directory either
  package writes, the other reads. :func:`load_index` makes every check and
  refusal the reference makes and verifies the content fingerprint on the
  host numpy arrays before it moves them to the device.
  :func:`save_timeline` / :func:`load_timeline` persist a
  :class:`ShardedTimeline` as one index directory per generation.
* **Growth.** :func:`add_passages` and :func:`new_generation` encode new
  passages against an index's frozen centroid, PQ and PLAID codebooks
  (``index.quantize_tokens``, ``pq.encode_pq``,
  ``residual.encode_residual``) on the index's device. The drift sums run
  in numpy on the host in the reference's order, so the meta floats agree
  to the bit.
* **Timelines.** :class:`ShardedTimeline` (generations sharing codebooks,
  merged by score in ``engine.retrieve_timeline``), :class:`EpochedTimeline`
  (codebook epochs, merged by rank), :func:`merge_generations` (compaction)
  and the footprint accounting.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import zipfile
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device, resolve_on
from .bitvector import MAX_PREDICATES, PredicateSet
from .index import (IndexMeta, PackedIndex, build_ivf, bytes_per_embedding,
                    index_from_arrays, pool_documents, quantize_tokens)
from .pq import encode_pq
from .precision import exact_matmuls
from .residual import encode_residual

SCHEMA_VERSION = 4
_FORMAT = "emvb-packed-index"
_TIMELINE_FORMAT = "emvb-sharded-timeline"
_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_V2_FIELDS = tuple(f for f in PackedIndex._fields if f != "pred_words")


def _fingerprint_arrays(arrays: dict, fields=None) -> str:
    h = hashlib.sha256()
    for f in (PackedIndex._fields if fields is None else fields):
        a = np.ascontiguousarray(arrays[f])
        h.update(f.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def index_fingerprint(index, *, fields=None) -> str:
    """Content fingerprint (ref ``store.py:74``): sha256 over each field's
    name, dtype string, shape repr and bytes, in field order, computed on
    host numpy. ``index`` is a :class:`PackedIndex` or a dict of numpy
    arrays keyed by field."""
    if isinstance(index, PackedIndex):
        index = {f: getattr(index, f).cpu().numpy()
                 for f in (PackedIndex._fields if fields is None else fields)}
    return _fingerprint_arrays(index, fields)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a numpy array on the host (uint32 stays
    uint32)."""
    return t.detach().cpu().numpy()


def _manifest(meta: IndexMeta, decl: dict, fingerprint: str) -> dict:
    """The manifest ``save_index`` writes: ``decl`` maps each field to its
    numpy dtype name and shape."""
    return {
        "format": _FORMAT,
        "schema_version": SCHEMA_VERSION,
        "fingerprint": fingerprint,
        "meta": dataclasses.asdict(meta),
        "arrays": {f: {"dtype": dtype, "shape": list(shape)}
                   for f, (dtype, shape) in decl.items()},
    }


def save_index(path: str, index: PackedIndex, meta: IndexMeta) -> str:
    """Write an index to ``path`` (a directory, created if missing) in the
    reference's format (ref ``store.py:102``): ``manifest.json`` (format,
    ``schema_version``, content ``fingerprint``, the full ``IndexMeta`` and
    each array's dtype and shape) and ``arrays.npz`` (every field,
    uncompressed). The manifest is JSON with ``indent=1``, byte-identical to
    the reference's for the same index. Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays = {f: _host(getattr(index, f)) for f in PackedIndex._fields}
    manifest = _manifest(
        meta, {f: (str(a.dtype), a.shape) for f, a in arrays.items()},
        _fingerprint_arrays(arrays))
    # The manifest gates validity: retract any existing one before touching
    # the arrays, write them, then publish the new manifest atomically, so a
    # crash at any point leaves a directory load_index rejects.
    mpath = os.path.join(path, _MANIFEST)
    if os.path.exists(mpath):
        os.remove(mpath)
    np.savez(os.path.join(path, _ARRAYS), **arrays)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, mpath)
    return path


def _fail(path: str, why: str) -> ValueError:
    return ValueError(f"load_index({path!r}): {why}")


def _read_meta(path: str, manifest: dict, version: int) -> IndexMeta:
    meta_fields = {f.name for f in dataclasses.fields(IndexMeta)}
    meta_dict = manifest.get("meta")
    if not isinstance(meta_dict, dict):
        raise _fail(path, f"{_MANIFEST} is missing the 'meta' table")
    if version < 3:
        meta_dict.setdefault("pred_names", [])
    if version < 4:
        meta_dict.setdefault("doc_budget", None)
        meta_dict.setdefault("n_raw_tokens", 0)
    missing = sorted(meta_fields - meta_dict.keys())
    unknown = sorted(meta_dict.keys() - meta_fields)
    if missing:
        raise _fail(path, f"manifest meta is missing field(s) {missing} — "
                          "corrupt or hand-edited manifest")
    if unknown:
        raise _fail(path, f"manifest meta has unknown field(s) {unknown} at "
                          f"schema_version={version}; new fields require a "
                          "schema version bump")
    pn = meta_dict["pred_names"]
    if not (isinstance(pn, list) and all(isinstance(n, str) for n in pn)):
        raise _fail(path, f"meta pred_names={pn!r} is not a list of "
                          "predicate name strings")
    if len(pn) > MAX_PREDICATES:
        raise _fail(path, f"meta declares {len(pn)} predicate names > "
                          f"{MAX_PREDICATES} (one bit per name in a uint32 "
                          "word)")
    meta_dict["pred_names"] = tuple(pn)
    db = meta_dict["doc_budget"]
    if db is not None and (isinstance(db, bool) or not isinstance(db, int)
                           or db < 1):
        raise _fail(path, f"meta doc_budget={db!r} is neither null nor a "
                          "positive integer")
    nrt = meta_dict["n_raw_tokens"]
    if isinstance(nrt, bool) or not isinstance(nrt, int) or nrt < 0:
        raise _fail(path, f"meta n_raw_tokens={nrt!r} is not a non-negative "
                          "integer")
    return IndexMeta(**meta_dict)


def _read_arrays(path: str, manifest: dict, version: int) -> dict:
    want_fields = PackedIndex._fields if version >= 3 else _V2_FIELDS
    decl = manifest.get("arrays")
    if not isinstance(decl, dict) or sorted(decl) != sorted(want_fields):
        raise _fail(path, "manifest 'arrays' table does not list exactly the "
                          f"schema-v{version} array set {sorted(want_fields)}")
    apath = os.path.join(path, _ARRAYS)
    if not os.path.isfile(apath):
        raise _fail(path, f"no {_ARRAYS} next to the manifest")
    try:
        with np.load(apath) as npz:
            arrays = {k: npz[k] for k in npz.files}
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise _fail(path, f"corrupt {_ARRAYS}: {e}") from e
    loaded = {}
    for f in want_fields:
        if f not in arrays:
            raise _fail(path, f"{_ARRAYS} is missing array {f!r} declared in "
                              "the manifest")
        a, want = arrays[f], decl[f]
        if str(a.dtype) != want["dtype"] or list(a.shape) != want["shape"]:
            raise _fail(path, f"array {f!r} is {a.dtype}{list(a.shape)} but "
                              f"the manifest declares {want['dtype']}"
                              f"{want['shape']} — corrupt save")
        loaded[f] = a
    if version < 3:
        loaded["pred_words"] = np.zeros(loaded["codes"].shape[0], np.uint32)
    return loaded


def _check(path: str, meta: IndexMeta, arrays: dict) -> None:
    n_docs, cap = arrays["codes"].shape
    if (meta.n_docs, meta.cap) != (n_docs, cap) or \
            meta.n_centroids != arrays["centroids"].shape[0]:
        raise _fail(path, f"meta (n_docs={meta.n_docs}, cap={meta.cap}, "
                          f"n_centroids={meta.n_centroids}) disagrees with "
                          f"the arrays (codes {n_docs}x{cap}, centroids "
                          f"{arrays['centroids'].shape[0]}) — corrupt save")
    if meta.doc_budget is not None and meta.cap > meta.doc_budget:
        raise _fail(path, f"meta declares doc_budget={meta.doc_budget} but "
                          f"cap={meta.cap} exceeds it")
    n_tokens = int(arrays["doc_lens"].sum())
    if meta.n_raw_tokens and meta.n_raw_tokens < n_tokens:
        raise _fail(path, f"meta n_raw_tokens={meta.n_raw_tokens} is below "
                          f"the stored token count {n_tokens}")
    pw = arrays["pred_words"]
    if pw.shape != (n_docs,):
        raise _fail(path, f"predicate plane pred_words has {list(pw.shape)} "
                          f"word(s) but the index has {n_docs} docs")
    n_names = len(meta.pred_names)
    if n_names < MAX_PREDICATES and pw.size and (int(pw.max()) >> n_names):
        raise _fail(path, "predicate plane has bits set beyond the "
                          f"{n_names} name(s) in meta.pred_names "
                          f"{meta.pred_names}")


def load_index(path: str, device=None) -> tuple[PackedIndex, IndexMeta]:
    """Load an index written by ``repro.core.store.save_index`` onto
    ``device`` (CUDA unless ``"cpu"`` is asked for) — ref ``store.py:139``.
    Every failure mode raises an actionable ``ValueError``."""
    device = resolve_device(device)      # before any bytes are read
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.isfile(mpath):
        raise _fail(path, f"no {_MANIFEST} — not a saved EMVB index (or a "
                          "save was interrupted before the manifest was "
                          "written)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise _fail(path, f"corrupt {_MANIFEST}: {e}") from e
    if not isinstance(manifest, dict) or manifest.get("format") != _FORMAT:
        fmt = manifest.get("format") if isinstance(manifest, dict) else None
        raise _fail(path, f"{_MANIFEST} has format={fmt!r}, expected "
                          f"{_FORMAT!r}")
    version = manifest.get("schema_version")
    if not isinstance(version, int) or version < 1:
        raise _fail(path, f"bad schema_version={version!r}")
    if version > SCHEMA_VERSION:
        raise _fail(path, f"schema_version={version} is newer than this "
                          f"build understands (<= {SCHEMA_VERSION})")
    meta = _read_meta(path, manifest, version)
    arrays = _read_arrays(path, manifest, version)
    _check(path, meta, arrays)
    if version >= 2:
        declared = manifest.get("fingerprint")
        if not isinstance(declared, str):
            raise _fail(path, "manifest has no 'fingerprint' at "
                              f"schema_version={version} (required since "
                              "v2)")
        actual = _fingerprint_arrays(
            arrays, PackedIndex._fields if version >= 3 else _V2_FIELDS)
        if declared != actual:
            raise _fail(path, f"manifest fingerprint {declared[:12]}… "
                              f"disagrees with the array contents "
                              f"({actual[:12]}…) — the arrays were modified "
                              "after the save, or the save is corrupt")
    return index_from_arrays(arrays, device), meta


# ---------------------------------------------------------------------------
# Growth: encode new passages against frozen codebooks (ref ``store.py:304``)
# ---------------------------------------------------------------------------

@exact_matmuls()
def _encode_passages(index: PackedIndex, doc_embs: np.ndarray,
                     doc_lens: np.ndarray):
    """Encode new passages against an index's frozen codebooks on its device
    (ref ``store.py:308``): ``quantize_tokens``, PQ after the OPQ rotation
    (skipped when it is the identity, as in the reference), and the PLAID
    codec. -> (codes, res_codes, plaid_res, residual_sq_sum, n_tokens); the
    sum of squared real residuals is numpy's, over the same float32 bits."""
    n_new, cap, d = doc_embs.shape
    codes, residual_flat, mask = quantize_tokens(index.centroids, doc_embs,
                                                 doc_lens)
    rotation = index.opq_rotation
    if torch.equal(rotation, torch.eye(d, dtype=rotation.dtype,
                                       device=rotation.device)):
        residual_rot = residual_flat
    else:
        residual_rot = residual_flat @ rotation
    m = index.res_codes.shape[-1]
    res_codes = encode_pq(residual_rot, index.pq).reshape(n_new, cap, m)
    plaid_res = encode_residual(residual_flat, index.plaid_codec)
    plaid_res = plaid_res.reshape(n_new, cap, -1)
    real = _host(residual_flat[torch.from_numpy(mask.reshape(-1)).to(
        residual_flat.device)])
    return codes, res_codes, plaid_res, float(np.sum(real * real)), \
        int(mask.sum())


def _pool_new_docs(meta: IndexMeta, doc_embs: np.ndarray,
                   doc_lens: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, int]:
    """Apply the index's document budget to incoming raw passages (ref
    ``store.py:337``): a budgeted index pools them with
    :func:`~.index.pool_documents` first and pads (or trims all-zero
    columns) to its ``cap``; an unbudgeted one passes them through.
    -> (doc_embs, doc_lens, n_raw pre-pooling tokens)."""
    doc_embs = np.asarray(doc_embs, dtype=np.float32)
    doc_lens = np.asarray(doc_lens, dtype=np.int32)
    n_raw = int(doc_lens.sum()) if doc_lens.ndim == 1 else 0
    if meta.doc_budget is None or doc_embs.ndim != 3:
        return doc_embs, doc_lens, n_raw
    doc_embs, doc_lens = pool_documents(doc_embs, doc_lens,
                                        meta.doc_budget)
    cap = doc_embs.shape[1]
    if cap < meta.cap:                       # pad pooled docs to index cap
        pad = np.zeros((doc_embs.shape[0], meta.cap - cap,
                        doc_embs.shape[2]), np.float32)
        doc_embs = np.concatenate([doc_embs, pad], axis=1)
    elif cap > meta.cap:
        if int(doc_lens.max(initial=0)) > meta.cap:
            raise ValueError(
                f"new passages still hold up to {int(doc_lens.max())} "
                f"vectors after pooling to doc_budget="
                f"{meta.doc_budget}, but the index cap is {meta.cap} — "
                "the base corpus never filled the budget; rebuild with a "
                "larger cap (or a budget <= cap) to grow these docs")
        doc_embs = doc_embs[:, :meta.cap]    # all-zero padding columns
    return doc_embs, doc_lens, n_raw


def _grown_raw_tokens(meta: IndexMeta, n_raw: int) -> int:
    """``meta.n_raw_tokens`` after growth (ref ``store.py:375``): exact where
    the index tracks raw tokens; a pre-v4 unbudgeted index stays at 0."""
    if meta.n_raw_tokens == 0 and meta.doc_budget is None:
        return 0
    return meta.n_raw_tokens + n_raw


def _check_new_docs(meta: IndexMeta, doc_embs: np.ndarray,
                    doc_lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Validate (and coerce) new-passage arrays against the index geometry
    (ref ``store.py:388``)."""
    doc_embs = np.asarray(doc_embs, dtype=np.float32)
    doc_lens = np.asarray(doc_lens, dtype=np.int32)
    if doc_embs.ndim != 3 or doc_embs.shape[0] != doc_lens.shape[0]:
        raise ValueError(
            f"doc_embs {doc_embs.shape} / doc_lens {doc_lens.shape}: "
            "expected (n_new, cap, d) embeddings with one length per doc")
    if doc_embs.shape[1] != meta.cap or doc_embs.shape[2] != meta.d:
        raise ValueError(
            f"new passages are padded to (cap={doc_embs.shape[1]}, "
            f"d={doc_embs.shape[2]}) but the index was built with "
            f"(cap={meta.cap}, d={meta.d}); re-pad (or truncate) the new "
            "docs to the index geometry first")
    if doc_embs.shape[0] == 0:
        raise ValueError("no passages to add (n_new=0)")
    return doc_embs, doc_lens


def _pack_new_predicates(meta: IndexMeta, n_new: int, predicates,
                         origin: str, device) -> torch.Tensor:
    """The predicate words (uint32, on ``device``) of newly grown docs (ref
    ``store.py:408``): an index with ``pred_names`` requires exactly those
    predicates for every new doc, packed in the index's name order; an index
    without a plane refuses predicates."""
    if not meta.pred_names:
        if predicates is not None:
            raise ValueError(
                f"{origin}: predicates were given but the index has no "
                "predicate plane (meta.pred_names is empty) — build the "
                "base index with build_index(predicates=...) first")
        return torch.zeros(n_new, dtype=torch.uint32, device=device)
    if predicates is None:
        raise ValueError(
            f"{origin}: the index has predicate plane {meta.pred_names} "
            "but no predicates were given for the new docs — every doc "
            "must carry every named predicate")
    if isinstance(predicates, PredicateSet):
        pset = predicates
    else:
        if sorted(predicates) != sorted(meta.pred_names):
            raise ValueError(
                f"{origin}: new docs carry predicates "
                f"{tuple(sorted(predicates))} but the index's plane is "
                f"{meta.pred_names} — names must match exactly")
        pset = PredicateSet.pack({n: predicates[n]
                                  for n in meta.pred_names})
    if pset.names != tuple(meta.pred_names):
        raise ValueError(
            f"{origin}: predicate names {pset.names} do not match the "
            f"index's plane {meta.pred_names} (bit positions are fixed at "
            "build time; pack in the index's name order)")
    words = pset.words
    if words.shape[0] != n_new:
        raise ValueError(
            f"{origin}: predicate plane covers {words.shape[0]} docs but "
            f"{n_new} docs are being added")
    return words.to(device)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def add_passages(index: PackedIndex, meta: IndexMeta, doc_embs: np.ndarray,
                 doc_lens: np.ndarray, predicates=None, *,
                 device=None) -> tuple[PackedIndex, IndexMeta]:
    """Append passages to an index without re-running k-means (ref
    ``store.py:452``), on ``device`` (CUDA unless ``"cpu"`` is asked for),
    where the index must live.

    New docs are encoded against the frozen codebooks; their ids continue
    after the corpus; each IVF list grows (``list_cap`` grows instead of
    dropping entries, the pad becomes the new ``n_docs``). ``meta.n_grown``
    and ``meta.grown_quant_mse`` track the grown docs' mean squared
    residual against ``meta.train_quant_mse`` (``meta.drift``).

    doc_embs   : (n_new, cap, d) float32, zero-padded to the index's cap and
                 d — a budgeted index (``meta.doc_budget``) takes raw docs
                 at any cap and pools them as the build would have
    doc_lens   : (n_new,) int
    predicates : the new docs' predicates when the index has a plane (a
                 ``{name: (n_new,) bool}`` mapping or PredicateSet over
                 exactly ``meta.pred_names``), else None
    -> a new (PackedIndex, IndexMeta); the inputs are unchanged
    """
    dev = resolve_on(index.device, device)
    doc_embs, doc_lens, n_raw = _pool_new_docs(meta, doc_embs, doc_lens)
    doc_embs, doc_lens = _check_new_docs(meta, doc_embs, doc_lens)
    n_old, n_new = meta.n_docs, doc_embs.shape[0]
    n_total = n_old + n_new
    new_pred = _pack_new_predicates(meta, n_new, predicates, "add_passages",
                                    dev)
    new_codes, new_res, new_plaid, sq_sum, n_tok = _encode_passages(
        index, doc_embs, doc_lens)

    # the IVF: each old list, then the new docs' list behind it
    add_ivf, add_lens, _, _ = build_ivf(
        new_codes, meta.n_centroids, None, origin="add_passages")
    old_lens = index.ivf_lens.long()
    need = old_lens + add_lens.long()
    list_cap = max(meta.list_cap, int(need.max()))
    ivf = torch.full((meta.n_centroids, list_cap), n_total,
                     dtype=torch.int32, device=dev)
    c, j = _live(index.ivf.shape[1], old_lens)
    ivf[c, j] = index.ivf[c, j]
    c, j = _live(add_ivf.shape[1], add_lens.long())
    ivf[c, old_lens[c] + j] = add_ivf[c, j] + n_old

    # drift over every grown doc: the old grown ones and this batch
    all_lens = index.doc_lens
    old_grown_tok = int(all_lens[n_old - meta.n_grown:].sum())
    grown_tok = old_grown_tok + n_tok
    grown_mse = (meta.grown_quant_mse * old_grown_tok + sq_sum) / \
        max(grown_tok, 1)

    plaid_res = index.plaid_res
    if plaid_res.shape[0] == n_old:                 # real PLAID codes
        plaid_res = torch.cat([plaid_res, new_plaid])
    grown = index._replace(
        codes=torch.cat([index.codes, new_codes]),
        doc_lens=torch.cat([all_lens, _tensor(doc_lens, dev)]),
        res_codes=torch.cat([index.res_codes, new_res]),
        ivf=ivf, ivf_lens=need.to(torch.int32), plaid_res=plaid_res,
        pred_words=torch.cat([index.pred_words, new_pred]))
    grown_meta = dataclasses.replace(
        meta, n_docs=n_total, list_cap=list_cap, n_grown=meta.n_grown + n_new,
        grown_quant_mse=float(grown_mse),
        n_raw_tokens=_grown_raw_tokens(meta, n_raw))
    return grown, grown_meta


def _live(width: int, lens: torch.Tensor):
    """(row, column) of every live entry of a padded (len(lens), width)
    list table whose row r holds lens[r] entries."""
    live = torch.arange(width, device=lens.device)[None, :] < lens[:, None]
    return live.nonzero(as_tuple=True)


def new_generation(base: PackedIndex, base_meta: IndexMeta,
                   doc_embs: np.ndarray, doc_lens: np.ndarray,
                   predicates=None, *, device=None
                   ) -> tuple[PackedIndex, IndexMeta]:
    """A fresh, self-contained generation of new passages only, encoded
    against a base index's frozen codebooks (ref ``store.py:537``), on
    ``device`` (CUDA unless ``"cpu"`` is asked for), where the base must
    live.

    Doc ids are local; the IVF is built for the generation alone and sized
    to its longest list; every doc counts as grown, so ``meta.drift``
    measures how far the stream moved from the base's training data.
    ``predicates`` follows :func:`add_passages`; a budgeted base pools the
    raw docs first and the budget carries forward.
    -> (PackedIndex, IndexMeta) of the new generation
    """
    dev = resolve_on(base.device, device)
    doc_embs, doc_lens, n_raw = _pool_new_docs(base_meta, doc_embs,
                                               doc_lens)
    doc_embs, doc_lens = _check_new_docs(base_meta, doc_embs, doc_lens)
    n_new = doc_embs.shape[0]
    pred_words = _pack_new_predicates(base_meta, n_new, predicates,
                                      "new_generation", dev)
    codes, res_codes, plaid_res, sq_sum, n_tok = _encode_passages(
        base, doc_embs, doc_lens)
    ivf, ivf_lens, list_cap, n_dropped = build_ivf(
        codes, base_meta.n_centroids, None, origin="new_generation")
    gen = base._replace(
        codes=codes, doc_lens=_tensor(doc_lens, dev), res_codes=res_codes,
        ivf=ivf, ivf_lens=ivf_lens, plaid_res=plaid_res,
        pred_words=pred_words)
    gen_meta = dataclasses.replace(
        base_meta, n_docs=n_new, list_cap=list_cap, n_dropped=n_dropped,
        n_grown=n_new, grown_quant_mse=sq_sum / max(n_tok, 1),
        n_raw_tokens=n_raw)
    return gen, gen_meta


# ---------------------------------------------------------------------------
# Multi-generation timeline (ref ``store.py:595``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedTimeline:
    """An ordered sequence of immutable index generations served as one
    corpus (ref ``store.py:600``, PLAID SHIRTTT's temporal sharding).
    Generation g's local doc ids map to global ids at ``offsets[g]``. Query
    it through ``engine.retrieve_timeline``."""

    generations: tuple[PackedIndex, ...]
    metas: tuple[IndexMeta, ...]

    def __post_init__(self):
        """Validate the generation/meta pairing and codebook compatibility:
        equal geometry and predicate names, and equal centroid and PQ
        codebook contents (``torch.equal`` on the generations' device)."""
        if len(self.generations) != len(self.metas):
            raise ValueError(
                f"{len(self.generations)} generation(s) but "
                f"{len(self.metas)} meta(s)")
        if not self.generations:
            raise ValueError("a ShardedTimeline needs >= 1 generation")
        d0 = self.metas[0]
        geom = ("n_centroids", "d", "cap", "m", "nbits", "plaid_b")
        for g, m in enumerate(self.metas[1:], start=1):
            mine = tuple(getattr(m, f) for f in geom)
            base = tuple(getattr(d0, f) for f in geom)
            if mine != base:
                raise ValueError(
                    f"generation {g} geometry {dict(zip(geom, mine))} "
                    f"differs from generation 0 {dict(zip(geom, base))}; "
                    "generations must share the frozen codebooks (build "
                    "them with store.new_generation)")
            if tuple(m.pred_names) != tuple(d0.pred_names):
                raise ValueError(
                    f"generation {g} has predicate plane {m.pred_names} "
                    f"but generation 0 has {d0.pred_names}; one compiled "
                    "FilterPlan serves a whole timeline, so predicate bit "
                    "positions must agree everywhere (grow generations "
                    "with store.new_generation, passing the same "
                    "predicate names)")
        # equal geometry can be a coincidence (two independent builds):
        # scores compare only under equal codebook CONTENTS
        c0 = self.generations[0]
        for g, gen in enumerate(self.generations[1:], start=1):
            if not (torch.equal(gen.centroids, c0.centroids) and
                    torch.equal(gen.pq_codebooks, c0.pq_codebooks)):
                raise ValueError(
                    f"generation {g} was quantized against different "
                    "centroid/PQ codebooks than generation 0 — its scores "
                    "are not comparable and a merged top-k would be "
                    "silently wrong. Build generations from one base index "
                    "with store.new_generation (a re-trained codebook "
                    "starts a NEW timeline epoch)")

    @property
    def offsets(self) -> tuple[int, ...]:
        """Global doc-id offset of each generation (cumulative n_docs)."""
        offs, acc = [], 0
        for m in self.metas:
            offs.append(acc)
            acc += m.n_docs
        return tuple(offs)

    @functools.cached_property
    def fingerprints(self) -> tuple[str, ...]:
        """Content fingerprint (:func:`index_fingerprint`) per generation,
        computed once per timeline object: every change builds a new
        timeline, whose changed generations hash anew."""
        return tuple(index_fingerprint(g) for g in self.generations)

    @property
    def n_docs(self) -> int:
        """Total docs across all generations."""
        return sum(m.n_docs for m in self.metas)

    def __len__(self) -> int:
        """Number of generations."""
        return len(self.generations)

    def __iter__(self) -> Iterator[tuple[PackedIndex, IndexMeta, int]]:
        """Yield (index, meta, global-id offset) per generation, in order."""
        return iter(zip(self.generations, self.metas, self.offsets))

    def append(self, index: PackedIndex, meta: IndexMeta) -> "ShardedTimeline":
        """A new timeline with ``index`` appended as the latest generation."""
        return ShardedTimeline(self.generations + (index,),
                               self.metas + (meta,))

    def with_newest(self, index: PackedIndex,
                    meta: IndexMeta) -> "ShardedTimeline":
        """A new timeline with the newest generation replaced by ``index``
        (the ``add_passages`` step on the open generation); older
        generations are immutable, and no offset moves."""
        return ShardedTimeline(self.generations[:-1] + (index,),
                               self.metas[:-1] + (meta,))

    @classmethod
    def of(cls, *pairs: tuple[PackedIndex, IndexMeta]) -> "ShardedTimeline":
        """Build a timeline from (index, meta) pairs in arrival order."""
        return cls(tuple(i for i, _ in pairs), tuple(m for _, m in pairs))


def merge_generations(timeline: ShardedTimeline, lo: int,
                      hi: int) -> ShardedTimeline:
    """Compact generations ``[lo, hi)`` of a timeline into one generation
    (ref ``store.py:723``), on the generations' device.

    Per-doc arrays concatenate in generation order, so every doc keeps its
    global id; each centroid's IVF list is the generations' lists one after
    another, each shifted by its generation's local offset (entries a
    generation's build dropped stay dropped); ``n_docs``/``n_dropped`` sum,
    ``list_cap`` fits the longest merged list, and the drift statistic
    merges token-weighted over the grown suffix of the range. Under
    cut-lossless budgets ``retrieve_timeline`` of the result equals that of
    the input, ids and score bits.
    """
    n_gens = len(timeline)
    if not (isinstance(lo, int) and isinstance(hi, int)
            and 0 <= lo < hi <= n_gens):
        raise ValueError(
            f"merge_generations range [lo={lo}, hi={hi}) is not a valid "
            f"generation slice of a {n_gens}-generation timeline")
    if hi - lo < 2:
        raise ValueError(
            f"merge_generations range [lo={lo}, hi={hi}) spans a single "
            "generation — nothing to compact")
    gens = timeline.generations[lo:hi]
    metas = timeline.metas[lo:hi]
    budgets = {m.doc_budget for m in metas}
    if len(budgets) > 1:
        raise ValueError(
            f"merge_generations range [lo={lo}, hi={hi}) mixes document "
            f"budgets {sorted(budgets, key=str)} — a merged generation has "
            "ONE doc_budget and pooled/unpooled docs must not be conflated "
            "silently; re-encode one side (store.new_generation against a "
            "common base) before compacting")
    n_total = sum(m.n_docs for m in metas)
    for g, (gen, m) in enumerate(zip(gens, metas), start=lo):
        if gen.plaid_res.shape[0] != m.n_docs:
            raise ValueError(
                f"generation {g} carries placeholder PLAID residuals "
                f"(shape {tuple(gen.plaid_res.shape)} for "
                f"{m.n_docs} docs) — only full generations can be merged")

    # IVF: per centroid, each generation's list behind the previous ones,
    # its doc ids shifted by the generation's local offset
    n_c = metas[0].n_centroids
    lens = torch.stack([g.ivf_lens.long() for g in gens])        # (R, n_c)
    need = lens.sum(0)
    list_cap = max(8, int(need.max()))
    first = gens[0]
    ivf = torch.full((n_c, list_cap), n_total, dtype=torch.int32,
                     device=first.device)
    cursor = torch.zeros_like(need)
    off = 0
    for r, (gen, m) in enumerate(zip(gens, metas)):
        c, j = _live(gen.ivf.shape[1], lens[r])
        ivf[c, cursor[c] + j] = gen.ivf[c, j] + off
        cursor += lens[r]
        off += m.n_docs

    # drift statistic: token-weighted over the grown suffix of the range
    n_grown, num, tok = 0, 0.0, 0
    tail_open = True
    for gen, m in zip(reversed(gens), reversed(metas)):
        if not tail_open or m.n_grown == 0:
            tail_open = False
            continue
        n_grown += m.n_grown
        t = int(gen.doc_lens[m.n_docs - m.n_grown:].sum())
        num += m.grown_quant_mse * t
        tok += t
        if m.n_grown < m.n_docs:
            tail_open = False

    def cat(field):
        return torch.cat([getattr(g, field) for g in gens])

    merged = first._replace(
        codes=cat("codes"), doc_lens=cat("doc_lens"),
        res_codes=cat("res_codes"), ivf=ivf,
        ivf_lens=need.to(torch.int32), plaid_res=cat("plaid_res"),
        pred_words=cat("pred_words"))
    # raw-token accounting survives only if every generation tracked it
    n_raw = (sum(m.n_raw_tokens for m in metas)
             if all(m.n_raw_tokens for m in metas) else 0)
    merged_meta = dataclasses.replace(
        metas[0], n_docs=n_total, list_cap=list_cap,
        n_dropped=sum(m.n_dropped for m in metas), n_grown=n_grown,
        grown_quant_mse=float(num / tok) if tok else 0.0,
        n_raw_tokens=n_raw)
    return ShardedTimeline(
        timeline.generations[:lo] + (merged,) + timeline.generations[hi:],
        timeline.metas[:lo] + (merged_meta,) + timeline.metas[hi:])


@dataclasses.dataclass(frozen=True)
class EpochedTimeline:
    """An ordered sequence of codebook epochs, each a
    :class:`ShardedTimeline` (ref ``store.py:863``). Global doc ids
    concatenate across epochs (``epoch_offsets``); ``retrieve_timeline``
    merges by score within an epoch and by rank across epochs."""

    epochs: tuple[ShardedTimeline, ...]

    def __post_init__(self):
        """Validate epoch types and the shared query geometry (d, cap)."""
        if not self.epochs:
            raise ValueError("an EpochedTimeline needs >= 1 epoch")
        for e, tl in enumerate(self.epochs):
            if not isinstance(tl, ShardedTimeline):
                raise ValueError(
                    f"epoch {e} is a {type(tl).__name__}, expected a "
                    "ShardedTimeline (wrap single indexes with "
                    "ShardedTimeline.of)")
        m0 = self.epochs[0].metas[0]
        for e, tl in enumerate(self.epochs[1:], start=1):
            m = tl.metas[0]
            if (m.d, m.cap) != (m0.d, m0.cap):
                raise ValueError(
                    f"epoch {e} has (d={m.d}, cap={m.cap}) but epoch 0 has "
                    f"(d={m0.d}, cap={m0.cap}); every epoch serves the same "
                    "queries, so the embedding geometry must match "
                    "(codebooks MAY differ — that is what epochs are for)")

    @classmethod
    def of(cls, timeline) -> "EpochedTimeline":
        """Wrap a plain ``ShardedTimeline`` as one epoch (idempotent on an
        ``EpochedTimeline``)."""
        if isinstance(timeline, cls):
            return timeline
        return cls((timeline,))

    @property
    def epoch_offsets(self) -> tuple[int, ...]:
        """Global doc-id offset of each epoch (cumulative epoch n_docs)."""
        offs, acc = [], 0
        for tl in self.epochs:
            offs.append(acc)
            acc += tl.n_docs
        return tuple(offs)

    @property
    def n_docs(self) -> int:
        """Total docs across all epochs."""
        return sum(tl.n_docs for tl in self.epochs)

    @property
    def n_generations(self) -> int:
        """Total generations across all epochs."""
        return sum(len(tl) for tl in self.epochs)

    def __len__(self) -> int:
        """Number of epochs."""
        return len(self.epochs)

    def __iter__(self) -> Iterator[tuple[ShardedTimeline, int]]:
        """Yield (epoch timeline, global doc-id offset), oldest first."""
        return iter(zip(self.epochs, self.epoch_offsets))

    def with_newest_epoch(self, tl: ShardedTimeline) -> "EpochedTimeline":
        """A new EpochedTimeline with the live (last) epoch replaced."""
        return EpochedTimeline(self.epochs[:-1] + (tl,))

    def append_epoch(self, tl: ShardedTimeline) -> "EpochedTimeline":
        """A new EpochedTimeline with ``tl`` opened as the live epoch."""
        return EpochedTimeline(self.epochs + (tl,))


def save_timeline(path: str, timeline: ShardedTimeline) -> str:
    """Persist a timeline (ref ``store.py:950``): one :func:`save_index`
    directory per generation (``gen-0000``, ...) plus a ``timeline.json``
    listing them in order with their content fingerprints. Returns
    ``path``."""
    os.makedirs(path, exist_ok=True)
    names = []
    for g, (index, meta, _) in enumerate(timeline):
        name = f"gen-{g:04d}"
        save_index(os.path.join(path, name), index, meta)
        names.append(name)
    with open(os.path.join(path, "timeline.json"), "w") as f:
        json.dump({"format": _TIMELINE_FORMAT,
                   "schema_version": SCHEMA_VERSION,
                   "generations": names,
                   "fingerprints": list(timeline.fingerprints)}, f, indent=1)
    return path


def load_timeline(path: str, device=None) -> ShardedTimeline:
    """Load a timeline written by either package's ``save_timeline`` onto
    ``device`` (CUDA unless ``"cpu"`` is asked for; ref ``store.py:968``);
    raises an actionable ``ValueError`` on corruption or a swapped
    generation directory."""
    device = resolve_device(device)      # before any bytes are read
    tpath = os.path.join(path, "timeline.json")
    if not os.path.isfile(tpath):
        raise ValueError(f"load_timeline({path!r}): no timeline.json — not "
                         "a saved timeline")
    try:
        with open(tpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(
            f"load_timeline({path!r}): corrupt timeline.json: {e}") from e
    if manifest.get("format") != _TIMELINE_FORMAT:
        raise ValueError(
            f"load_timeline({path!r}): format={manifest.get('format')!r}, "
            f"expected {_TIMELINE_FORMAT!r}")
    version = manifest.get("schema_version")
    if not isinstance(version, int) or version > SCHEMA_VERSION:
        raise ValueError(
            f"load_timeline({path!r}): schema_version={version!r} is not "
            f"readable by this build (<= {SCHEMA_VERSION})")
    names = manifest.get("generations")
    if not isinstance(names, list) or not names:
        raise ValueError(f"load_timeline({path!r}): empty or missing "
                         "'generations' list")
    pairs = [load_index(os.path.join(path, n), device) for n in names]
    timeline = ShardedTimeline.of(*pairs)
    _check_timeline_fingerprints(path, version, manifest, names, timeline)
    return timeline


def _check_timeline_fingerprints(path: str, version: int, manifest: dict,
                                 names: list, timeline: ShardedTimeline
                                 ) -> None:
    """Each loaded generation is the one ``timeline.json`` lists (ref
    ``store.py:1000``, schema v2+): its manifest fingerprint (which
    ``load_index`` just verified against its arrays) must equal the
    declared one. The verified values seed ``timeline.fingerprints`` only
    when every generation manifest is current-schema (pre-v3 fingerprints
    hash the v2 field subset)."""
    if version < 2:
        return
    declared = manifest.get("fingerprints")
    if not isinstance(declared, list) or len(declared) != len(names):
        raise ValueError(
            f"load_timeline({path!r}): timeline.json needs one fingerprint "
            f"per generation at schema_version={version} "
            f"(got {declared!r} for {len(names)} generation(s))")
    actual, seed_ok = [], True
    for g, name in enumerate(names):
        with open(os.path.join(path, name, _MANIFEST)) as f:
            gman = json.load(f)
        got = gman.get("fingerprint")
        if got is None:     # a v1 generation directory: hash it this once
            got = index_fingerprint(timeline.generations[g])
        elif gman.get("schema_version", 0) < SCHEMA_VERSION:
            seed_ok = False
        actual.append(got)
    for name, want, got in zip(names, declared, actual):
        if want != got:
            raise ValueError(
                f"load_timeline({path!r}): generation {name!r} has "
                f"fingerprint {got[:12]}… but timeline.json declares "
                f"{want[:12]}… — the generation directory was replaced "
                "after the timeline was saved")
    if seed_ok:
        timeline.__dict__["fingerprints"] = tuple(actual)


# ---------------------------------------------------------------------------
# Footprint accounting (ref ``store.py:1047``)
# ---------------------------------------------------------------------------

def _np_dtype(t: torch.Tensor) -> str:
    """The numpy dtype name a tensor's bytes save as."""
    return str(t.new_empty(0, device="cpu").numpy().dtype)


def generation_footprint(index: PackedIndex, meta: IndexMeta) -> dict:
    """Byte footprint of one generation as stored and as served (ref
    ``store.py:1055``), from the tensors' shapes and dtypes (no bytes leave
    the device): ``array_bytes`` per field, ``index_bytes``,
    ``manifest_bytes`` (the manifest ``save_index`` writes, fingerprint
    included), ``total_bytes``, ``predicate_bytes``, the paper's
    ``bytes_per_embedding`` and the real ``bytes_per_embedding_actual``, and
    the constant-space views ``bytes_per_doc``, ``unpooled_bytes_per_doc``
    and ``pooling_savings``. Equal to the reference's dict, floats
    included."""
    arrays = {f: getattr(index, f) for f in PackedIndex._fields}
    array_bytes = {f: a.numel() * a.element_size() for f, a in arrays.items()}
    index_bytes = sum(array_bytes.values())
    # a placeholder fingerprint: size-accurate, hash-free
    manifest = _manifest(
        meta, {f: (_np_dtype(a), a.shape) for f, a in arrays.items()}, "0" * 64)
    manifest_bytes = len(json.dumps(manifest, indent=1).encode())
    n_tokens = int(index.doc_lens.sum())
    payload = (array_bytes["codes"] + array_bytes["res_codes"]
               + array_bytes["plaid_res"])
    # per-token width of the packed payload: a centroid id, the PQ codes and
    # the PLAID residual codes of one stored token slot
    tok_bytes = (arrays["codes"].element_size()
                 + arrays["res_codes"].shape[-1]
                 * arrays["res_codes"].element_size()
                 + arrays["plaid_res"].shape[-1]
                 * arrays["plaid_res"].element_size())
    n_raw = meta.n_raw_tokens or n_tokens
    n_docs_ = max(meta.n_docs, 1)
    return {
        "n_docs": meta.n_docs,
        "n_tokens": n_tokens,
        "n_raw_tokens": n_raw,
        "doc_budget": meta.doc_budget,
        "bytes_per_doc": tok_bytes * n_tokens / n_docs_,
        "unpooled_bytes_per_doc": tok_bytes * n_raw / n_docs_,
        "pooling_savings": 1.0 - n_tokens / max(n_raw, 1),
        "array_bytes": array_bytes,
        "index_bytes": index_bytes,
        "manifest_bytes": manifest_bytes,
        "total_bytes": index_bytes + manifest_bytes,
        "predicate_bytes": array_bytes["pred_words"],
        "bytes_per_embedding": bytes_per_embedding(meta, "emvb"),
        "bytes_per_embedding_actual": payload / max(n_tokens, 1),
    }


def timeline_footprint(timeline) -> dict:
    """Byte footprint of a whole :class:`ShardedTimeline` or
    :class:`EpochedTimeline` (ref ``store.py:1123``): the per-generation
    footprints plus the ``timeline.json`` overhead, summed (an epoched one
    sums its epochs and adds ``n_epochs``)."""
    if isinstance(timeline, EpochedTimeline):
        per = [timeline_footprint(tl) for tl in timeline.epochs]
        n_tokens = sum(p["n_tokens"] for p in per)
        payload = sum(p["bytes_per_embedding_actual"] * p["n_tokens"]
                      for p in per)
        return {
            "n_epochs": len(per),
            "n_generations": sum(p["n_generations"] for p in per),
            "n_docs": timeline.n_docs,
            "n_tokens": n_tokens,
            "generations": [g for p in per for g in p["generations"]],
            "index_bytes": sum(p["index_bytes"] for p in per),
            "manifest_bytes": sum(p["manifest_bytes"] for p in per),
            "total_bytes": sum(p["total_bytes"] for p in per),
            "predicate_bytes": sum(p["predicate_bytes"] for p in per),
            "bytes_per_embedding": per[0]["bytes_per_embedding"],
            "bytes_per_embedding_actual": payload / max(n_tokens, 1),
            **_pooling_rollup(per, timeline.n_docs),
        }
    gens = [generation_footprint(g, m) for g, m, _ in timeline]
    tj = {"format": _TIMELINE_FORMAT, "schema_version": SCHEMA_VERSION,
          "generations": [f"gen-{g:04d}" for g in range(len(timeline))],
          "fingerprints": ["0" * 64] * len(timeline)}
    timeline_manifest_bytes = len(json.dumps(tj, indent=1).encode())
    n_tokens = sum(g["n_tokens"] for g in gens)
    index_bytes = sum(g["index_bytes"] for g in gens)
    manifest_bytes = (sum(g["manifest_bytes"] for g in gens)
                      + timeline_manifest_bytes)
    payload = sum(g["bytes_per_embedding_actual"] * g["n_tokens"]
                  for g in gens)
    return {
        "n_generations": len(timeline),
        "n_docs": timeline.n_docs,
        "n_tokens": n_tokens,
        "generations": gens,
        "index_bytes": index_bytes,
        "manifest_bytes": manifest_bytes,
        "total_bytes": index_bytes + manifest_bytes,
        "predicate_bytes": sum(g["predicate_bytes"] for g in gens),
        "bytes_per_embedding": gens[0]["bytes_per_embedding"],
        "bytes_per_embedding_actual": payload / max(n_tokens, 1),
        **_pooling_rollup(gens, timeline.n_docs),
    }


def _pooling_rollup(parts: list, n_docs: int) -> dict:
    """The constant-space keys over per-generation (or per-epoch) footprints
    (ref ``store.py:1177``): doc-weighted payload sums; ``doc_budget`` is the
    common value, or ``"mixed"``."""
    pooled = sum(p["bytes_per_doc"] * p["n_docs"] for p in parts)
    raw = sum(p["unpooled_bytes_per_doc"] * p["n_docs"] for p in parts)
    budgets = {p["doc_budget"] for p in parts}
    return {
        "n_raw_tokens": sum(p["n_raw_tokens"] for p in parts),
        "doc_budget": (parts[0]["doc_budget"] if len(budgets) == 1
                       else "mixed"),
        "bytes_per_doc": pooled / max(n_docs, 1),
        "unpooled_bytes_per_doc": raw / max(n_docs, 1),
        "pooling_savings": 1.0 - pooled / max(raw, 1e-9),
    }
