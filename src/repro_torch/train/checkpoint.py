"""Chunked, atomic checkpoints in the reference's format (counterpart of
``repro/train/checkpoint.py``), so a checkpoint saved by one package
restores in the other.

Format: ``<dir>/step_<N>/``
  manifest.json       — step, chunk count, extra metadata, and each leaf's
                        key, shape and dtype in the tree's leaf order
  <leaf-key>.c<i>.npy — the leaf split along axis 0 into ``n_chunks``
                        pieces (a scalar in one)

A leaf's key joins its path with ``__`` (``params__layers__attn__wq``), as
the reference's ``_leaf_key`` does for dict trees. Writes go to
``<dir>/.tmp_step_<N>`` and are renamed at the end (POSIX rename: an atomic
publish), so a crash mid-save never corrupts the latest checkpoint. Trees
are nested dicts (and lists) of numpy arrays or tensors; bf16 tensors are
saved as float32 (numpy has no bf16) and restore into a bf16 model exactly.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import tree as tree_lib


def _leaf_key(path) -> str:
    """The file stem of the leaf at ``path`` (ref ``checkpoint.py:30``)."""
    return "__".join(str(p) for p in path)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.float() if t.dtype == torch.bfloat16 else t
        return t.cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, tree: Any, step: int, *, n_chunks: int = 1,
         extra_meta: Optional[dict] = None) -> str:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>`` (ref
    ``checkpoint.py:42``) -> that directory."""
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "n_chunks": n_chunks,
                "extra": extra_meta or {}, "leaves": []}
    for path, leaf in tree_lib.leaves(tree):
        key = _leaf_key(path)
        arr = _numpy(leaf)
        manifest["leaves"].append({
            "key": key, "shape": list(arr.shape), "dtype": str(arr.dtype)})
        chunks = np.array_split(arr, n_chunks, axis=0) if arr.ndim else [arr]
        for i, c in enumerate(chunks):
            np.save(os.path.join(tmp, f"{key}.c{i}.npy"), c)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest ``step_<N>`` under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """-> (a tree of numpy arrays with ``tree_like``'s structure, step)
    (ref ``checkpoint.py:78``): the chunks concatenated, whatever
    ``n_chunks`` the save used. The latest step by default."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n_chunks = manifest["n_chunks"]
    by_key = {}
    for leaf in manifest["leaves"]:
        key = leaf["key"]
        if len(leaf["shape"]) == 0 or n_chunks == 1:
            arr = np.load(os.path.join(d, f"{key}.c0.npy"))
        else:
            arr = np.concatenate(
                [np.load(os.path.join(d, f"{key}.c{i}.npy"))
                 for i in range(n_chunks)], axis=0)
        by_key[key] = arr.reshape(leaf["shape"]).astype(leaf["dtype"],
                                                        copy=False)
    out = {}
    for path, _ in tree_lib.leaves(tree_like):
        key = _leaf_key(path)
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        out[path] = by_key[key]
    return _rebuild(tree_like, out), step


def _rebuild(like: Any, flat: dict, prefix: tuple = ()) -> Any:
    """``like``'s structure with the leaf at each path taken from
    ``flat``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, prefix + (i,))
                          for i, v in enumerate(like))
    return flat[prefix]
