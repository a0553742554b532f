"""The one traffic generator: reads a mix's parameters from
``perfbench/traffic/<name>.json`` and makes every query a run sends, on the
device and before the window opens.

A mix's keys:

* ``loop``: the name of the loop that sends the batches and reads the
  end-to-end metrics, ``perfbench/loops/<loop>.py`` (``closed``: one
  client, ``clients`` = 1, submitting a batch of ``batch`` queries and
  waiting for its results on the host before it submits the next).
* ``live_terms``: live terms a query (the configuration's ``n_q``: ColBERT
  pads every query to it, so every term is live).
* ``pool_batches_per_s``: how many distinct batches the run makes for each
  second of its window; a window that would use more ends when the pool
  is spent, so no query is sent twice.
* ``warmup_calls``: batches of other queries sent before the window, which
  warm every shape the window uses.
* ``check_batches``: batches of the window, drawn from the seed, that the
  reference checks after the window closes.
* ``trace``: in a ``--trace 1`` run, the profiler skips ``wait_calls``
  calls, warms up over ``warmup_calls`` and records ``calls``.
* ``filter``: null, or ``{"predicates": P, "pass_share": s}``: the run
  makes a plane of P predicates, each held by a share s of the docs, and
  batch i carries the filter "predicate i mod P holds".

Every seed gets the same number of batches of the same shape: the seed
changes which docs and queries, not how much work.
"""
from __future__ import annotations

import json
import math
import os
from typing import NamedTuple, Optional

import torch

from . import planted

# sub-seeds of a run's --seed, so that no two draws share a stream
DATA, QUERIES, PLANE, WARMUP = 0, 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    """The generator seed of one stream of a run."""
    return seed * 4 + stream


class Traffic(NamedTuple):
    """The batches a run sends, all on the device."""

    batches: torch.Tensor            # (N, B, n_q, d) float32
    warmup: torch.Tensor             # (W, B, n_q, d) float32
    filters: Optional[list]          # predicate of each window batch
    warm_filters: Optional[list]
    plane: Optional[torch.Tensor]    # (n_docs,) uint32, or None


def load(path: str) -> dict:
    """A traffic mix's parameters."""
    with open(path) as f:
        return json.load(f)


def pool_batches(mix: dict, seconds: float) -> int:
    """Distinct batches a run of ``seconds`` makes."""
    return max(1, math.ceil(seconds * mix["pool_batches_per_s"]))


def make(mix: dict, data: planted.PlantedData, seed: int, seconds: float,
         n_q: int, min_batches: int = 1) -> Traffic:
    """Every query and filter of one run, from its seed: at least
    ``min_batches`` window batches."""
    if mix["live_terms"] != n_q:
        raise ValueError(f"live_terms={mix['live_terms']} but the "
                         f"configuration's n_q is {n_q}: only full queries "
                         "are generated")
    b = mix["batch"]
    n = max(pool_batches(mix, seconds), min_batches)
    w = mix["warmup_calls"]
    d = data.centroids.shape[1]
    q, _ = planted.make_queries(data, sub_seed(seed, QUERIES), n * b, n_q)
    wq, _ = planted.make_queries(data, sub_seed(seed, WARMUP), w * b, n_q)
    filt = mix.get("filter")
    plane = filters = warm_filters = None
    if filt:
        p = filt["predicates"]
        plane = planted.make_predicate_plane(
            sub_seed(seed, PLANE), data.codes.shape[0], p,
            filt["pass_share"], data.codes.device)
        filters = [i % p for i in range(n)]
        warm_filters = [i % p for i in range(w)]
    return Traffic(q.reshape(n, b, n_q, d), wq.reshape(w, b, n_q, d),
                   filters, warm_filters, plane)


def path_of(root: str, name: str) -> str:
    """The file of the traffic mix ``name``."""
    return os.path.join(root, "traffic", name + ".json")
