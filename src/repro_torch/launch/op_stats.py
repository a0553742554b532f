"""A cell's program counted op by op (counterpart of
``repro/launch/hlo_stats.py``, which reads compiled HLO; nothing here is
compiled, so the program's own aten ops are counted as eager torch runs
them).

:class:`OpCounter`, a ``TorchDispatchMode``, sees every aten op of a run
and counts:

  * FLOPs of the products, ``2·|result|·contraction`` (the rule of
    ``hlo_stats.py:152``), by ``torch.utils.flop_counter``'s formulas;
  * HBM bytes: every op's output bytes plus the bytes of its tensor
    arguments, views excepted (they move nothing), and a row gather's table
    counted as the rows it returns. Eager torch materializes every op's
    output, so this is eager's own count, not a fused program's;
  * the peak of live bytes: each storage an op creates is live from that op
    until it is freed (a weak reference's callback);
  * a hand-written kernel's bytes and operations, which its wrapper reports
    on meta by its bound's formula (``kernels/_meta.py``).

:func:`reckon` turns one cell (``launch/steps.py``) into the dry run's
per-chip record. The reckoning, a chip's share of the global program:

  * argument bytes from ``sharding.rules.shard_shape`` of every leaf under
    its spec, exactly;
  * FLOPs, bytes and the activation peak from the global run on meta,
    divided as the specs divide the work (:func:`work_split`): an LM's
    tokens over the data axes times its weights over "model" (every chip);
    a recommender's batch over the axes its spec names; the GCN's sampled
    batch over the data axes, and on a full graph its products whole (the
    features and weights are whole) and its bytes over the axes the edges
    shard over;
  * the retrieval family's program is the per-chip one itself: one
    device's ``_local_retrieve`` at one shard's shapes;
  * collective bytes by kind, from the specs (:func:`collectives`), with
    the ring factors of ``launch/analysis.py``: FSDP all-gathers and
    reduce-scatters, the tensor-parallel all-reduces or, with
    sequence-parallel residuals, their reduce-scatter / all-gather pairs,
    the experts' all-to-alls, the data-parallel gradient all-reduce, the
    decode's partial-sum all-reduces over a sharded cache, the recsys
    tables' row exchange (all-to-all) and top-k merge, the GCN's partial
    aggregations, and the retrieval plan's all-gather of B·k.

An LM's layers are alike and its microbatches too, so its counts are
affine in the layer count and bilinear with the microbatch count: the
program runs at 1 and 2 layers (and 2 and 3 microbatches) and the counts
are extrapolated, exactly, to the config's. Repeated Newton–Schulz calls on
matrices of one shape are counted once and replayed (a meta tensor's counts
depend on its shape only). Both keep kimi-k2-1t-a32b's step at seconds.
The peak is a maximum, affine only while its place in the program stays:
a train step's is in the backward at a large batch and in its tail (the
optimizer's update) at a small one, where the largest leaf's temporaries
decide it, and the largest leaf changes with the layer count. So the tail
is a segment of its own (:func:`mark`): its peak is the live bytes it
starts from, extrapolated, plus its rise counted at the full size, which
takes no forward and no backward; the rest is extrapolated (granite's
smoke config at 3 layers and 4 microbatches: 0.32 % low, ``tests/
test_torch_dryrun.py``). What an op allocates inside its kernel and frees
before it returns (a CUDA backward's contiguous copies inside a batched
product) is no op's output and is not counted: granite-moe-1b-a400m's
train step on the card allocated 1.39 GB a 4,096-token sequence more than
counted in its backward (``chip_smoke.py``'s dryrun phase prints the
reckoned peak over ``max_memory_allocated``).

The reference's ``xla_cost_flops_unscaled`` (XLA's own cost analysis, which
counts a loop body once) has no counterpart here and is not recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref
from typing import Any, Callable

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import _meta
from ..sharding.rules import axes_of, shard_shape
from . import analysis
from .mesh import data_axes, n_devices
from .modelflops import model_flops
from .steps import Cell, build_cell, leaves

_aten = torch.ops.aten
# ops that allocate without reading or writing
_NO_DATA = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten.new_empty.default, _aten.new_empty_strided.default,
            _aten.empty_like.default, _aten._unsafe_view.default,
            _aten.lift_fresh.default}
# row gathers: they read the rows they return, not the whole table
_GATHERS = {_aten.embedding.default, _aten.index.Tensor,
            _aten.index_select.default, _aten.gather.default}
COUNTS = ("flops", "bytes", "kernel_bytes", "kernel_ops", "n_ops",
          "peak_temp_bytes", "output_bytes")


def tensors(tree: Any):
    """Every tensor of a tree of modules, (named) tuples, lists and dicts,
    as it is (a module's parameters and buffers, not their layout)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)


def _flat(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _flat(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_counters: list = []      # the counters running, innermost last


def mark(name: str) -> None:
    """From here on the running counters keep their live-byte peak apart,
    as segment ``name`` of the program (a train step's tail: the
    optimizer's update and what follows it)."""
    for c in _counters:
        c.enter(name)


class OpCounter(TorchDispatchMode):
    """Counts a run's FLOPs, bytes and live-byte peak (module docstring),
    the peak by segment (:func:`mark`), with the live bytes each segment
    began with. Storages of ``exclude`` (the arguments) are never counted
    as live."""

    def __init__(self, exclude=()):
        super().__init__()
        self.flops = self.bytes = self.n_ops = 0
        self.kernel_bytes = self.kernel_ops = 0
        self.kernels: dict = {}
        self.live = 0
        self.segment = "main"
        self.peaks = {"main": 0}
        self.entries = {"main": 0}
        self._known: dict = {}
        for t in exclude:
            self._known.setdefault(id(t.untyped_storage()), None)

    def _freed(self, sid: int, nbytes: int):
        def cb(_ref):
            if self._known.pop(sid, None) is not None:
                self.live -= nbytes
        return cb

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        sid = id(st)
        if sid in self._known:
            return
        nb = st.nbytes()
        self._known[sid] = weakref.ref(st, self._freed(sid, nb))
        self.live += nb
        if self.live > self.peaks[self.segment]:
            self.peaks[self.segment] = self.live

    @property
    def peak(self) -> int:
        return max(self.peaks.values())

    def enter(self, name: str) -> None:
        self.segment = name
        self.entries.setdefault(name, self.live)
        self.peaks[name] = max(self.peaks.get(name, 0), self.live)

    def __enter__(self):
        _counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _counters.remove(self)
        return super().__exit__(*exc)

    def on_kernel(self, kernel: str, nbytes: int, ops: int) -> None:
        self.kernel_bytes += nbytes
        self.kernel_ops += ops
        self.kernels[kernel] = self.kernels.get(kernel, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))
        outs = _flat(out, [])
        if not (func.is_view or func in _NO_DATA):
            ins = _flat(args, [])
            _flat(list(kwargs.values()), ins)
            if func in _GATHERS:
                ins = [t for t in ins if not t.is_floating_point()] + outs
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out


@contextlib.contextmanager
def _replayed_newton_schulz(counter: OpCounter):
    """Within the block, muon's Newton–Schulz on a meta matrix is run once
    per (shape, dtype, steps) and replayed after: the counts it added and
    the live bytes it rose by are added again, and an empty result of its
    shape is returned."""
    from ..train import optimizer
    real = optimizer._newton_schulz
    seen: dict = {}

    def ns(g, steps: int = 5, dtype=torch.float32):
        if not g.is_meta:
            return real(g, steps, dtype)
        key = (tuple(g.shape), g.dtype, steps, dtype)
        seg = counter.segment
        if key not in seen:
            before = (counter.flops, counter.bytes, counter.n_ops)
            live0, peak0 = counter.live, counter.peaks[seg]
            counter.peaks[seg] = live0
            out = real(g, steps, dtype)
            rise = counter.peaks[seg] - live0
            counter.peaks[seg] = max(peak0, counter.peaks[seg])
            seen[key] = ((counter.flops - before[0],
                          counter.bytes - before[1],
                          counter.n_ops - before[2]), rise,
                         tuple(out.shape), out.dtype)
            return out
        (fl, by, n), rise, shape, dt = seen[key]
        counter.flops += fl
        counter.bytes += by
        counter.n_ops += n - 1          # the empty() below counts one
        counter.peaks[seg] = max(counter.peaks[seg], counter.live + rise)
        return torch.empty(shape, dtype=dt, device=g.device)

    optimizer._newton_schulz = ns
    try:
        yield
    finally:
        optimizer._newton_schulz = real


def count(fn: Callable, args: tuple) -> dict:
    """Run ``fn(*args)`` under an :class:`OpCounter` -> its counts:
    ``flops``, ``bytes``, ``kernel_bytes``, ``kernel_ops``, ``n_ops``,
    ``peak_temp_bytes`` (live bytes above the arguments at their peak),
    ``output_bytes`` (the result's storages that are not the arguments'),
    and ``kernels`` (meta calls by kernel)."""
    from torch.fx.experimental import _config as fx_config
    arg_tensors = list(tensors(args))
    counter = OpCounter(exclude=arg_tensors)
    # a boolean mask's selection on meta keeps every element: the dense
    # upper bound, as the kernels' meta bytes take it
    with _meta.sink(counter.on_kernel), _replayed_newton_schulz(counter), \
            fx_config.patch(meta_nonzero_assume_all_nonzero=True):
        with counter:
            out = fn(*args)
    arg_ids = {id(t.untyped_storage()) for t in arg_tensors}
    out_st = {}
    for t in tensors(out):
        st = t.untyped_storage()
        if id(st) not in arg_ids:
            out_st[id(st)] = st.nbytes()
    return {"flops": counter.flops, "bytes": counter.bytes,
            "kernel_bytes": counter.kernel_bytes,
            "kernel_ops": counter.kernel_ops, "n_ops": counter.n_ops,
            "peak_temp_bytes": counter.peak,
            "output_bytes": sum(out_st.values()),
            "segment_peaks": dict(counter.peaks),
            "segment_entries": dict(counter.entries),
            "kernels": dict(counter.kernels)}


# ---------------------------------------------------------------------------
# the global program, extrapolated over an LM's layers and microbatches
# ---------------------------------------------------------------------------

def _variant(cell: Cell, n_layers: int, microbatches: int) -> Cell:
    """``cell`` rebuilt with ``n_layers`` layers and ``microbatches``
    microbatches of the same size."""
    spec, shape = cell.spec, cell.spec.shapes[cell.shape]
    ga = cell.grad_accum
    dims = dict(shape.dims)
    if ga > 1:
        dims["batch"] = dims["batch"] // ga * microbatches
    base = spec.make_config

    def make_config(*a, **k):
        return dataclasses.replace(base(*a, **k), n_layers=n_layers)
    var = dataclasses.replace(
        spec, make_config=make_config,
        shapes={cell.shape: dataclasses.replace(
            shape, dims=dims, grad_accum=microbatches if ga > 1 else 1)})
    return build_cell(var, cell.shape, cell.mesh)


def global_counts(cell: Cell) -> dict:
    """:func:`count` of the cell's whole program on meta; an LM's
    extrapolated from 1 and 2 layers (and 2 and 3 microbatches) to its
    config's (module docstring)."""
    if cell.family != "lm":
        return count(cell.fn, cell.args)
    L, ga = cell.cfg.n_layers, cell.grad_accum
    gs = (2, 3) if ga > 1 else (1,)
    c = {(l, g): count(*_variant(cell, l, g)[:2]) for l in (1, 2) for g in gs}

    def extrapolate(get):
        c11, c21 = get(c[(1, gs[0])]), get(c[(2, gs[0])])
        v = c11 + (L - 1) * (c21 - c11)
        if ga > 1:
            c12, c22 = get(c[(1, 3)]), get(c[(2, 3)])
            v += (ga - 2) * (c12 - c11) + (L - 1) * (ga - 2) * (
                c22 - c21 - c12 + c11)
        return v
    out = {k: extrapolate(lambda r, k=k: r[k]) for k in COUNTS}
    peaks = {"main": extrapolate(lambda r: r["segment_peaks"]["main"])}
    if cell.kind == "train":
        # the tail's peak: the live bytes it starts from (affine) and its
        # own rise, counted at the config's size (no forward, no backward)
        peaks["tail"] = extrapolate(lambda r: r["segment_entries"][
            "tail"]) + _tail_rise(cell)
    out["segment_peaks"] = peaks
    out["peak_temp_bytes"] = max(peaks.values())
    out["kernels"] = {}
    return out


def _tail_rise(cell: Cell) -> int:
    """The live bytes a train step's tail adds to what it starts from, at
    the cell's full size on meta: the optimizer's update, the new
    parameters loaded back and the gradient norm, as
    ``train.trainer.make_train_step`` runs them, on gradients in the
    reference's layout (float32 when microbatches accumulate them)."""
    from ..models import load_reference_layout, to_reference_layout
    from .steps import _optimizer_for
    state = cell.args[0]
    layout = to_reference_layout(state.params)
    grads = {p: torch.empty(t.shape, device=t.device, dtype=(
        torch.float32 if cell.grad_accum > 1 else t.dtype))
        for p, t in layout.items()}
    opt = _optimizer_for(cell.spec)

    def tail(grads, opt_state, layout, params):
        new_params, new_opt = opt.update(grads, opt_state, layout)
        load_reference_layout(params, new_params)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
        return new_opt, gnorm
    return count(tail, (grads, state.opt_state, layout, state.params)
                 )["peak_temp_bytes"]


# ---------------------------------------------------------------------------
# the per-chip reckoning
# ---------------------------------------------------------------------------

def _ways(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in axes_of(entry))


def argument_bytes(cell: Cell) -> int:
    """Bytes a chip holds of the arguments: every leaf's local shape under
    its spec, exactly."""
    return sum(math.prod(shard_shape(t.shape, cell.specs[p], cell.mesh))
               * t.element_size() for p, t in leaves(cell.args).items())


def work_split(cell: Cell) -> tuple:
    """(ways the FLOPs divide, ways the bytes and activations divide) over
    the chips (module docstring)."""
    mesh, specs = cell.mesh, cell.specs
    if cell.family == "lm":
        return n_devices(mesh), n_devices(mesh)
    if cell.family == "retrieval":
        return 1, 1
    batch = [sp for p, sp in specs.items() if p[0] == 1 and sp]
    if cell.family == "gnn" and cell.kind == "train":
        return 1, _ways(mesh, specs[(1, "edges")][1])
    ways = _ways(mesh, batch[0][0])
    return ways, ways


def _dtype_bytes(dt) -> int:
    return torch.empty((), dtype=dt).element_size()


class _Coll:
    """Link bytes a chip sends, by kind, and the collectives counted."""

    def __init__(self):
        self.by_kind: dict = {}
        self.sites = 0

    def add(self, kind: str, result_bytes: float, group: int,
            times: int = 1) -> None:
        if group <= 1 or times <= 0 or result_bytes <= 0:
            return
        link = analysis.collective_link_bytes(kind, result_bytes, group)
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + link * times
        self.sites += times

    def tp(self, act: float, group: int, sp: bool, times: int) -> None:
        """Tensor-parallel partial sums of ``act`` bytes: all-reduces, or
        reduce-scatter + all-gather pairs under sequence parallelism."""
        if sp:
            self.add("reduce-scatter", act / group, group, times)
            self.add("all-gather", act, group, times)
        else:
            self.add("all-reduce", act, group, times)


def _param_leaves(cell: Cell) -> dict:
    """{path: (global bytes, TP-local bytes, chip-local bytes,
    fsdp ways)} of the parameters."""
    mesh = cell.mesh
    lv = leaves(cell.args)
    head = (0,) if isinstance(cell.args[0], nn.Module) else (0, "params")
    out = {}
    for p, sp in cell.specs.items():
        if p[:len(head)] != head:
            continue
        t = lv[p]
        item = t.element_size()
        tp = tuple(e if "model" in axes_of(e) and len(axes_of(e)) == 1
                   else None for e in sp)
        fs = tuple(None if e is None or "model" in axes_of(e) else e
                   for e in sp)
        out[p] = (t.numel() * item,
                  math.prod(shard_shape(t.shape, tp, mesh)) * item,
                  math.prod(shard_shape(t.shape, sp, mesh)) * item,
                  math.prod(_ways(mesh, e) for e in fs))
    return out


def _lm_collectives(cell: Cell, c: _Coll) -> None:
    cfg, mesh, dims = cell.cfg, cell.mesh, cell.dims
    M = mesh.shape["model"]
    D = math.prod(mesh.shape[a] for a in data_axes(mesh))
    L, d = cfg.n_layers, cfg.d_model
    dt = _dtype_bytes(cfg.dtype)
    b, s, ga = dims["batch"], dims["seq"], cell.grad_accum
    sp = cfg.residual_spec is not None
    params = _param_leaves(cell)
    moe_layers = L if cfg.is_moe else 0
    cf = cfg.capacity_factor
    if cell.kind == "train":
        act = -(-b // ga // D) * s * d * dt
        tp_per_layer = 4 + (2 if cfg.remat_policy == "full" else 0)
        c.tp(act, M, sp, tp_per_layer * L * ga)
        tok = act / dt / d / (M if sp else 1)
        c.add("all-to-all", tok * cfg.top_k * cf * d * dt, M,
              4 * moe_layers * ga)
        for glob, tp_local, local, f in params.values():
            if f > 1:
                c.add("all-gather", tp_local, f, 2 * ga)
                c.add("reduce-scatter", local, f, ga)
            else:
                c.add("all-reduce", tp_local, D)
        return
    for glob, tp_local, local, f in params.values():
        c.add("all-gather", tp_local, f)
    if cell.kind == "prefill":
        act = -(-b // D) * s * d * dt
        c.tp(act, M, sp, 2 * L)
        tok = act / dt / d / (M if sp else 1)
        c.add("all-to-all", tok * cfg.top_k * cf * d * dt, M,
              2 * moe_layers)
        return
    # decode: one token a sequence over a cache whose head_dim is over
    # "model" (partial-sum logits) and, for one long sequence, whose
    # positions are over the data axes (softmax statistics and output)
    b_chip = -(-b // D) if b >= D else b
    s_chip = s if b >= D else -(-s // D)
    c.tp(b_chip * d * dt, M, False, 2 * L)
    c.add("all-reduce", b_chip * cfg.n_heads * s_chip * 4, M, L)
    if b < D:
        c.add("all-reduce", b * cfg.n_heads * (cfg.d_head + 2) * 4, D, L)
    c.add("all-to-all", b_chip * cfg.top_k * d * dt, M, 2 * moe_layers)


def _lookups(arch: str, cfg, kind: str) -> dict:
    """Rows a sample gathers from each table (by leaf name)."""
    if arch in ("dlrm-mlperf", "dcn-v2"):
        return {f"t{f}": cfg.nnz for f in range(cfg.n_sparse)}
    hist = cfg.seq_len + (0 if kind == "retrieval" else 1)
    if arch == "dien":
        return {"item_emb": hist, "cat_emb": hist}
    return {"item_emb": hist}


def _recsys_collectives(cell: Cell, c: _Coll) -> None:
    mesh, cfg = cell.mesh, cell.cfg
    lv = leaves(cell.args)
    bkey = next(p for p, sp in cell.specs.items() if p[0] == 1)
    n = lv[bkey].shape[0]
    bw = _ways(mesh, cell.specs[bkey][0])
    rows = _lookups(cell.spec.name, cfg, cell.kind)
    times = 2 if cell.kind == "train" else 1
    dense = 0
    for p, (glob, tp_local, local, f) in _param_leaves(cell).items():
        sp = cell.specs[p]
        name = str(p[-1])
        g = _ways(mesh, sp[0]) if sp else 1
        if g > 1 and name in rows:
            dim = lv[p].shape[-1] * lv[p].element_size()
            c.add("all-to-all", -(-n // bw) * rows[name] * dim, g, times)
        elif g == 1:
            dense += glob
    if cell.kind == "train":
        c.add("all-reduce", dense, bw)
    if cell.kind == "retrieval":
        # the top-100 merge over the shards of the scores
        g = bw if cell.spec.name != "mind" else _ways(
            mesh, cell.specs[(0, "item_emb")][0])
        c.add("all-gather", g * 100 * 8, g)


def _gnn_collectives(cell: Cell, c: _Coll) -> None:
    mesh, cfg, dims = cell.mesh, cell.cfg, cell.dims
    if cell.kind == "train":
        g = _ways(mesh, cell.specs[(1, "edges")][1])
        widths = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
        for w in widths:       # each propagation's partial sums, fwd + bwd
            c.add("all-reduce", dims["n_nodes"] * w * 4, g, 2)
        return
    dense = sum(glob for glob, *_ in _param_leaves(cell).values())
    c.add("all-reduce", dense, _ways(mesh, cell.specs[(1, "labels")][0]))


def collectives(cell: Cell) -> tuple:
    """({kind: link bytes a chip}, collectives counted) of one step, from
    the specs (module docstring)."""
    c = _Coll()
    if cell.family == "lm":
        _lm_collectives(cell, c)
    elif cell.family == "recsys":
        _recsys_collectives(cell, c)
    elif cell.family == "gnn":
        _gnn_collectives(cell, c)
    else:
        nd = n_devices(cell.mesh)
        qb = cell.dims["query_batch"]
        for _ in ("scores", "ids"):
            c.add("all-gather", nd * qb * cell.cfg.engine.k * 4, nd)
    return c.by_kind, c.sites


def reckon(cell: Cell, counts: dict = None) -> dict:
    """The dry run's record of one cell on its mesh (module docstring);
    ``counts``, the global program's (:func:`global_counts`), when the
    caller has them already (both meshes share them)."""
    t0 = time.perf_counter()
    mesh = cell.mesh
    chips = n_devices(mesh)
    g = counts if counts is not None else global_counts(cell)
    fsplit, bsplit = work_split(cell)
    by_kind, n_sites = collectives(cell)
    coll = sum(by_kind.values())
    args = argument_bytes(cell)
    temp = g["peak_temp_bytes"] / bsplit
    flops = g["flops"] / fsplit
    hbm = (g["bytes"] + g["kernel_bytes"]) / bsplit
    roof = analysis.roofline({"flops": flops, "bytes accessed": hbm}, coll,
                             model_flops(cell.spec, cell.shape), chips)
    peak = args + temp
    return {
        "arch": cell.spec.name, "shape": cell.shape, "mesh": mesh.name,
        "chips": chips, "reckon_s": time.perf_counter() - t0,
        "argument_bytes_per_chip": args,
        "output_bytes_per_chip": g["output_bytes"] / bsplit,
        "temp_bytes_per_chip": temp,
        "peak_bytes_per_chip": peak,
        "fits": peak < analysis.HBM_CAPACITY,
        "n_collective_sites": n_sites,
        "collective_by_kind_gib": {k: v / 2**30 for k, v in by_kind.items()},
        "flops_global": g["flops"], "bytes_global": g["bytes"],
        "kernel_bytes_global": g["kernel_bytes"],
        "kernel_ops_global": g["kernel_ops"],
        "work_split": [fsplit, bsplit],
        **roof,
    }
