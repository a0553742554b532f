"""The port's index and store read side against the reference: arrays carried
across by ``index_from_arrays``, directories written by
``repro.core.store.save_index`` loaded with an equal fingerprint, every
corruption refused, and ``build_ivf`` equal to the reference's
``_build_ivf``."""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core import store as rstore
from repro.core.index import PackedIndex as RefIndex, _build_ivf
from repro_torch.core import store as tstore
from repro_torch.core.index import PackedIndex, build_ivf, index_from_arrays

torch.set_num_threads(1)


def _arrays(index):
    return {f: np.asarray(getattr(index, f)) for f in RefIndex._fields}


def _assert_same(port: PackedIndex, arrays: dict) -> None:
    assert port._fields == RefIndex._fields
    for f in PackedIndex._fields:
        got = getattr(port, f).numpy()
        assert got.dtype == arrays[f].dtype, f
        np.testing.assert_array_equal(got, arrays[f], err_msg=f)


def test_index_from_arrays_equals_reference(small_index):
    ref, _ = small_index
    arrays = _arrays(ref)
    port = index_from_arrays(arrays, device="cpu")
    _assert_same(port, arrays)
    assert port.pred_words.dtype == torch.uint32
    np.testing.assert_array_equal(port.token_mask().numpy(),
                                  np.asarray(ref.token_mask()))
    assert tstore.index_fingerprint(port) == rstore.index_fingerprint(ref)


def test_load_index_reads_reference_save(small_index, tmp_path):
    ref, meta = small_index
    path = rstore.save_index(str(tmp_path / "idx"), ref, meta)
    port, pmeta = tstore.load_index(path, device="cpu")
    _assert_same(port, _arrays(ref))
    assert dataclasses.asdict(pmeta) == dataclasses.asdict(meta)
    with open(os.path.join(path, "manifest.json")) as f:
        declared = json.load(f)["fingerprint"]
    assert tstore.index_fingerprint(port) == declared
    assert tstore.SCHEMA_VERSION == rstore.SCHEMA_VERSION


def _rewrite(path, *, arrays=None, manifest=None):
    if arrays is not None:
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
    if manifest is not None:
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)


def _corrupt(kind, path):
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    if kind == "flipped_byte":
        codes = arrays["codes"].copy()
        codes.view(np.uint8)[17] ^= 0x40
        _rewrite(path, arrays={**arrays, "codes": codes})
    elif kind == "wrong_dtype":
        _rewrite(path, arrays={**arrays,
                               "codes": arrays["codes"].astype(np.int64)})
    elif kind == "future_schema":
        _rewrite(path, manifest={**manifest, "schema_version":
                                 rstore.SCHEMA_VERSION + 1})
    elif kind == "missing_manifest":
        os.remove(mpath)
    elif kind == "unknown_meta_field":
        _rewrite(path, manifest={**manifest, "meta": {**manifest["meta"],
                                                      "bogus": 1}})
    elif kind == "missing_array":
        del arrays["ivf"]
        _rewrite(path, arrays=arrays)
    elif kind == "stray_predicate_bits":
        pw = arrays["pred_words"].copy()
        pw[0] = 1
        _rewrite(path, arrays={**arrays, "pred_words": pw})


@pytest.mark.parametrize("kind", [
    "flipped_byte", "wrong_dtype", "future_schema", "missing_manifest",
    "unknown_meta_field", "missing_array", "stray_predicate_bits"])
def test_corrupt_saves_are_refused_like_the_reference(small_index, tmp_path,
                                                      kind):
    ref, meta = small_index
    path = rstore.save_index(str(tmp_path / kind), ref, meta)
    _corrupt(kind, path)
    with pytest.raises(ValueError) as want:
        rstore.load_index(path)
    with pytest.raises(ValueError) as got:
        tstore.load_index(path, device="cpu")
    # the same refusal: both messages start with the same check's words
    assert str(got.value).split("—")[0][:60] == \
        str(want.value).split("—")[0][:60]


def test_schema_v2_fallback(small_index, tmp_path):
    """A v2 save (no predicate plane, fingerprint over the v2 fields)
    loads with an empty plane, as the reference loads it."""
    ref, meta = small_index
    path = rstore.save_index(str(tmp_path / "v2"), ref, meta)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files if k != "pred_words"}
    m = manifest["meta"]
    for k in ("pred_names", "doc_budget", "n_raw_tokens"):
        del m[k]
    del manifest["arrays"]["pred_words"]
    manifest.update(schema_version=2, fingerprint=rstore.index_fingerprint(
        ref, fields=rstore._V2_FIELDS))
    _rewrite(path, arrays=arrays, manifest=manifest)
    want, wmeta = rstore.load_index(path)
    got, gmeta = tstore.load_index(path, device="cpu")
    _assert_same(got, _arrays(want))
    assert dataclasses.asdict(gmeta) == dataclasses.asdict(wmeta)


@pytest.mark.parametrize("list_cap", [None, 3])
def test_build_ivf_equals_reference(small_index, list_cap):
    ref, meta = small_index
    codes = np.array(ref.codes)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = _build_ivf(codes, meta.n_centroids, list_cap)
        got = build_ivf(torch.from_numpy(codes), meta.n_centroids, list_cap)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[2:] == want[2:]
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    overflow = ["overflowed" in str(w.message) for w in caught]
    assert overflow == ([True, True] if list_cap else [])
    assert (got[3] > 0) == bool(list_cap)
