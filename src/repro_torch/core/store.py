"""Reading a saved index (read side of ``repro/core/store.py``).

The on-disk format is ``manifest.json`` + ``arrays.npz`` (schema v4 with
its v1-v3 fallbacks). :func:`load_index` makes every check and refusal the
reference makes — format, future schema, meta fields, array dtypes and
shapes, meta/array agreement, the predicate plane, and (v2+) the content
fingerprint, recomputed here on the host numpy arrays with the reference's
byte recipe — and only then moves the arrays to the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile

import numpy as np

from ..device import resolve_device
from .index import IndexMeta, PackedIndex, index_from_arrays

SCHEMA_VERSION = 4
MAX_PREDICATES = 32  # one uint32 predicate word per document
_FORMAT = "emvb-packed-index"
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
