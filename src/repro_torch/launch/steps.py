"""Cell builders (counterpart of ``repro/launch/steps.py``): (arch x shape x
mesh) -> a step, its arguments and their specs.

:func:`build_cell` returns a :class:`Cell`: ``fn``, ``args``, a tree of
tensors on the ``meta`` device at their **global** shapes and dtypes, and
``specs``, ``{leaf path: spec}`` parallel to :func:`leaves` of ``args``,
each spec a tuple of mesh axes per dimension (``repro_torch.sharding``).
``fn(*args)`` on meta runs the program with no memory (``launch/op_stats.py``
counts it); the same ``fn`` on real tensors of those shapes runs on the
card, where a 1 x 1 mesh (``mesh.single_card_mesh``) makes every spec the
whole tensor.

Leaves carry the reference's paths: a train state is the port's
``TrainState(step, params, opt_state)`` whose step is a 0-d int32 tensor,
whose params are a module read in the reference's layout
(``models.reference_leaves``: a transformer's layers stacked) and whose
optimizer state is flat in that layout (``sharding.rules.state_leaves``),
so each leaf maps onto one of the reference's ``TrainState`` leaves.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from ..configs import registry
from ..models import reference_leaves, to_reference_layout
from ..sharding.recsys_rules import recsys_state_shardings
from ..sharding.rules import lm_state_shardings, replicated, state_leaves
from ..train import optimizer as opt_lib
from ..train.trainer import TrainerConfig, TrainState, make_train_step
from .mesh import Mesh, data_axes, fsdp_axes, n_devices

META = torch.device("meta")


class Cell(NamedTuple):
    """A built cell: the step, its arguments on meta, their specs, and what
    the dry run's reckoning reads (``launch/op_stats.py``)."""

    fn: Callable
    args: tuple
    specs: dict
    spec: registry.ArchSpec
    shape: str
    family: str
    kind: str
    cfg: Any
    dims: dict
    grad_accum: int
    mesh: Mesh


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _ways(mesh: Mesh, axes) -> int:
    """Devices along ``axes``."""
    return math.prod(mesh.shape[a] for a in axes)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def leaves(tree: Any, prefix: tuple = ()) -> dict:
    """``{path: tensor}`` of every leaf of an argument tree, each path the
    reference's: a NamedTuple's fields by name, a sequence's items by
    index, a dict's keys (a flat ``{path: ...}`` dict's paths spliced in),
    a module's leaves in the reference's layout."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, nn.Module):
        return {prefix + p: t for p, t in reference_leaves(tree).items()}
    out: dict = {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(leaves(getattr(tree, f), prefix + (f,)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(leaves(v, prefix + (i,)))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, prefix + (k if isinstance(k, tuple)
                                           else (k,))))
    else:
        raise TypeError(f"argument leaf {prefix} is a {type(tree).__name__}")
    return out


def _prefixed(prefix: tuple, specs: dict) -> dict:
    return {prefix + p: sp for p, sp in specs.items()}


def _optimizer_for(spec: registry.ArchSpec):
    if spec.optimizer == "muon":
        # momentum keeps its param sharding; Newton-Schulz in bf16, as the
        # reference's dry run builds it
        return _segmented(opt_lib.make("muon", state_dtype=torch.bfloat16,
                                       ns_dtype=torch.bfloat16))
    return _segmented(opt_lib.make(spec.optimizer))


def _segmented(opt):
    """``opt`` whose update begins the step's tail, a segment whose peak
    ``op_stats`` reckons apart (``op_stats.mark``); no number changes."""
    def update(*args):
        from .op_stats import mark
        mark("tail")
        return opt.update(*args)
    return opt._replace(update=update)


def _train_state(params: nn.Module, opt) -> TrainState:
    return TrainState(_meta((), torch.int32), params,
                      opt.init(to_reference_layout(params)))


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _decode_pos(ps: torch.Tensor, seq: int):
    """The decode position: the tensor itself on a device; on meta, where
    it has no value, the cache's last slot (attention spans the whole
    cache either way)."""
    return seq - 1 if ps.is_meta else ps


def _lm_cell(spec, shape_name: str, mesh: Mesh) -> tuple:
    from ..models import transformer as T

    cell = spec.shapes[shape_name]
    cfg = spec.make_config()
    dax = data_axes(mesh)
    fax = fsdp_axes(mesh) if spec.fsdp else None
    # context parallelism when head counts don't divide the model axis: the
    # q positions are sequence-sharded, with Megatron-SP residuals
    n_model = mesh.shape["model"]
    if (cell.kind in ("train", "prefill") and
            (cfg.n_heads % n_model or cfg.n_kv_heads % n_model)):
        qg_spec = (dax, None, "model", None, None, None)
        kv_spec = (dax, None, None, None, None)
        cfg = dataclasses.replace(cfg, attn_act_specs=(qg_spec, kv_spec),
                                  residual_spec=(dax, "model", None))
    # the experts' capacity gather with a token-sharded output
    if cfg.is_moe and cell.kind in ("train", "prefill"):
        cfg = dataclasses.replace(
            cfg, residual_spec=cfg.residual_spec or (dax, "model", None))
    params = T.abstract_params(cfg)
    flat = to_reference_layout(params)

    if cell.kind == "train":
        opt = _optimizer_for(spec)
        state = _train_state(params, opt)
        p_sp, o_sp = lm_state_shardings(mesh, flat,
                                        state_leaves(state.opt_state), fax)
        b, s, ga = cell.dims["batch"], cell.dims["seq"], cell.grad_accum
        tok_spec = (None, dax, None) if ga > 1 else (dax, None)
        tok_shape = (ga, b // ga, s) if ga > 1 else (b, s)
        batch = {"tokens": _meta(tok_shape, torch.int32),
                 "labels": _meta(tok_shape, torch.int32)}
        loss = functools.partial(T.loss_fn, cfg=cfg)
        step = make_train_step(lambda p, bt: loss(p, bt), opt,
                               TrainerConfig(grad_accum=ga))
        specs = {(0, "step"): (), **_prefixed((0, "params"), p_sp),
                 **_prefixed((0, "opt_state"), o_sp),
                 (1, "tokens"): tok_spec, (1, "labels"): tok_spec}
        return cfg, step, (state, batch), specs

    p_sp = lm_state_shardings(mesh, flat, {}, fax)[0]
    specs = _prefixed((0,), p_sp)

    if cell.kind == "prefill":
        b, s = cell.dims["batch"], cell.dims["seq"]
        specs[(1,)] = (dax, None)
        return (cfg, lambda p, t: T.prefill(p, t, cfg),
                (params, _meta((b, s), torch.int32)), specs)

    if cell.kind == "decode":
        b, s = cell.dims["batch"], cell.dims["seq"]
        kvh, dh, L = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
        # kv-head counts don't divide the model axis, so the cache shards
        # its head_dim over "model"; a single long sequence shards its
        # sequence axis over the data axes
        if b >= _ways(mesh, dax):
            cache_spec, tok_spec = (None, dax, None, None, "model"), (dax,)
        else:
            cache_spec, tok_spec = (None, None, dax, None, "model"), (None,)
        cache = T.KVCache(_meta((L, b, s, kvh, dh), cfg.dtype),
                          _meta((L, b, s, kvh, dh), cfg.dtype))
        specs.update({(1, "k"): cache_spec, (1, "v"): cache_spec,
                      (2,): tok_spec, (3,): ()})

        def decode_fn(p, c, t, ps):
            return T.decode_step(p, c, t, _decode_pos(ps, s), cfg)
        return cfg, decode_fn, (params, cache, _meta((b,), torch.int32),
                                _meta((), torch.int32)), specs

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _gnn_cell(spec, shape_name: str, mesh: Mesh) -> tuple:
    from ..models import gcn

    cell = spec.shapes[shape_name]
    cfg = spec.make_config(shape_name)
    dax = data_axes(mesh)
    all_ax = tuple(mesh.axis_names)
    opt = _optimizer_for(spec)
    state = _train_state(gcn.GCN(cfg, META), opt)
    specs = {(0, "step"): (),
             **_prefixed((0, "params"), replicated(leaves(state.params))),
             **_prefixed((0, "opt_state"),
                         replicated(state_leaves(state.opt_state)))}

    if cell.kind == "train":
        n, e, f = (cell.dims["n_nodes"], cell.dims["n_edges"],
                   cell.dims["d_feat"])
        # pad the edge list to a mesh multiple (masked edges are inert)
        e = _round_up(e, n_devices(mesh))
        batch = {"feats": _meta((n, f), torch.float32),
                 "edges": _meta((2, e), torch.int32),
                 "edge_mask": _meta((e,), torch.bool),
                 "labels": _meta((n,), torch.int32)}
        bspec = {"feats": (None, None), "edges": (None, all_ax),
                 "edge_mask": (all_ax,), "labels": (None,)}
        loss = functools.partial(gcn.loss_fn, cfg=cfg)
    elif cell.kind == "train_sampled":
        bn = cell.dims["batch_nodes"]
        f0, f1 = cell.dims["fanout0"], cell.dims["fanout1"]
        f = cell.dims["d_feat"]
        n1, n2 = bn * f0, bn * f0 * f1
        batch = {"feats0": _meta((bn, f), torch.float32),
                 "feats1": _meta((n1, f), torch.float32),
                 "feats2": _meta((n2, f), torch.float32),
                 "edges0": _meta((2, n1), torch.int32),
                 "edge_mask0": _meta((n1,), torch.bool),
                 "edges1": _meta((2, n2), torch.int32),
                 "edge_mask1": _meta((n2,), torch.bool),
                 "labels": _meta((bn,), torch.int32)}
        bspec = {"feats0": (dax, None), "feats1": (dax, None),
                 "feats2": (dax, None), "edges0": (None, dax),
                 "edge_mask0": (dax,), "edges1": (None, dax),
                 "edge_mask1": (dax,), "labels": (dax,)}
        loss = functools.partial(gcn.loss_fn_sampled, cfg=cfg)
    else:
        raise ValueError(cell.kind)
    specs.update(_prefixed((1,), {(k,): v for k, v in bspec.items()}))
    step = make_train_step(lambda p, b: loss(p, b), opt, TrainerConfig())
    return cfg, step, (state, batch), specs


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def _recsys_batch(arch: str, b: int, mesh: Mesh, cfg) -> tuple:
    """(batch, {key: spec}). The batch shards over ALL axes (the dense
    towers have no model-parallel dimension, so leaving "model" out would
    replicate their compute over it), else over the data axes only, else
    (batch 1) it is whole."""
    dax = tuple(mesh.axis_names)
    if b % _ways(mesh, dax):
        dax = data_axes(mesh)   # fall back to data-only sharding
        if b % _ways(mesh, dax):
            dax = None          # e.g. batch=1 retrieval: a whole batch
    i32, bl, f32 = torch.int32, torch.bool, torch.float32
    if arch in ("dlrm-mlperf", "dcn-v2"):
        shapes = {"dense": ((b, cfg.n_dense), f32),
                  "sparse_idx": ((b, cfg.n_sparse, cfg.nnz), i32),
                  "sparse_valid": ((b, cfg.n_sparse, cfg.nnz), bl),
                  "labels": ((b,), i32)}
    elif arch == "dien":
        L = cfg.seq_len
        shapes = {"hist_items": ((b, L), i32), "hist_cats": ((b, L), i32),
                  "hist_valid": ((b, L), bl), "target_item": ((b,), i32),
                  "target_cat": ((b,), i32), "labels": ((b,), i32)}
    elif arch == "mind":
        L = cfg.seq_len
        shapes = {"hist_items": ((b, L), i32), "hist_valid": ((b, L), bl),
                  "target_item": ((b,), i32)}
    else:
        raise ValueError(arch)
    batch = {k: _meta(s, dt) for k, (s, dt) in shapes.items()}
    return batch, {k: (dax,) + (None,) * (len(s) - 1)
                   for k, (s, _) in shapes.items()}


def _recsys_model(arch: str):
    if arch == "dlrm-mlperf":
        from ..models.recsys import dlrm as M
    elif arch == "dcn-v2":
        from ..models.recsys import dcn as M
    elif arch == "dien":
        from ..models.recsys import dien as M
    elif arch == "mind":
        from ..models.recsys import mind as M
    else:
        raise ValueError(arch)
    return M


def _model_class(M):
    return next(getattr(M, n) for n in ("DLRM", "DCN", "DIEN", "MIND")
                if hasattr(M, n))


def _pad_recsys_cfg(cfg, mesh: Mesh):
    """Row-shard divisibility: pad big tables to a multiple of the row-shard
    factor."""
    mult = mesh.shape.get("data", 1) * mesh.shape.get("model", 1)
    kw = {}
    if hasattr(cfg, "vocab_sizes"):
        kw["vocab_sizes"] = tuple(
            _round_up(v, mult) if v >= 100_000 else v
            for v in cfg.vocab_sizes)
    if hasattr(cfg, "vocab_items") and cfg.vocab_items >= 100_000:
        kw["vocab_items"] = _round_up(cfg.vocab_items, mult)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def _recsys_cell(spec, shape_name: str, mesh: Mesh) -> tuple:
    from ..core.topk import topk

    cell = spec.shapes[shape_name]
    cfg = _pad_recsys_cfg(spec.make_config(), mesh)
    M = _recsys_model(spec.name)
    params = _model_class(M)(cfg, META)

    def batch_of(b, drop=()):
        batch, bspec = _recsys_batch(spec.name, b, mesh, cfg)
        for k in drop:
            batch.pop(k, None)
            bspec.pop(k, None)
        return batch, {(1, k): v for k, v in bspec.items()}

    if cell.kind == "train":
        opt = _optimizer_for(spec)
        state = _train_state(params, opt)
        p_sp, o_sp = recsys_state_shardings(
            mesh, leaves(params), state_leaves(state.opt_state))
        batch, bspec = batch_of(cell.dims["batch"])
        loss = functools.partial(M.loss_fn, cfg=cfg)
        step = make_train_step(lambda p, b: loss(p, b), opt, TrainerConfig())
        specs = {(0, "step"): (), **_prefixed((0, "params"), p_sp),
                 **_prefixed((0, "opt_state"), o_sp), **bspec}
        return cfg, step, (state, batch), specs

    p_sp = _prefixed((0,), recsys_state_shardings(mesh, leaves(params),
                                                  {})[0])

    if cell.kind == "serve":
        batch, bspec = batch_of(cell.dims["batch"], ("labels",))
        return (cfg, lambda p, b: M.forward(p, b, cfg), (params, batch),
                {**p_sp, **bspec})

    if cell.kind == "retrieval":
        # the candidate set padded to a mesh multiple, so the ranking
        # compute shards over every axis
        ncand = _round_up(cell.dims["n_candidates"], n_devices(mesh))
        if spec.name == "mind":
            # multi-interest MaxSim over the candidates + top-k
            def step(p, b):
                caps = M.user_interests(p, b["hist_items"], b["hist_valid"],
                                        cfg)
                return topk(M.score_candidates(caps, p.item_emb[:ncand]),
                            100)
            batch, bspec = batch_of(cell.dims["batch"], ("target_item",))
            return cfg, step, (params, batch), {**p_sp, **bspec}
        # ranking models: score `ncand` items for one user
        batch, bspec = batch_of(ncand, ("labels",))

        def rank(p, b):
            return topk(M.forward(p, b, cfg), 100)
        return cfg, rank, (params, batch), {**p_sp, **bspec}

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# Retrieval family (the paper's own system at MS MARCO scale)
# ---------------------------------------------------------------------------

def _retrieval_cell(spec, shape_name: str, mesh: Mesh) -> tuple:
    """The production plan: each device owns a doc shard with a local IVF,
    runs the whole four-phase pipeline on it, and one all-gather of B·k
    merges the results (``launch/serve.py``; collective O(B·k), not
    O(corpus)). The index leaves carry a leading shard axis."""
    from ..core.index import PackedIndex

    cell = spec.shapes[shape_name]
    cfg = spec.make_config()
    all_ax = tuple(mesh.axis_names)
    ndev = n_devices(mesh)
    nd = _round_up(cfg.n_docs, ndev)              # doc padding (len-0 docs)
    per = nd // ndev
    cap, d, nc, m = cfg.doc_cap, cfg.d, cfg.n_centroids, cfg.m
    ksub = 1 << cfg.nbits
    qb = cell.dims["query_batch"]
    # the port's main path, the fused kernels (the reference's cell traces
    # its jnp math, use_kernels=False: the same function)
    ecfg = dataclasses.replace(cfg.engine, use_kernels=True)
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    shapes = dict(
        centroids=((nc, d), f32), codes=((per, cap), i32),
        doc_lens=((per,), i32), res_codes=((per, cap, m), u8),
        pq_codebooks=((m, ksub, d // m), f32), ivf=((nc, cfg.list_cap), i32),
        ivf_lens=((nc,), i32), plaid_res=((1, 1, 1), u8),
        plaid_cutoffs=((3,), f32), plaid_weights=((4,), f32),
        opq_rotation=((d, d), f32), pred_words=((per,), torch.uint32))
    index = PackedIndex(**{k: _meta((ndev, *s), dt)
                           for k, (s, dt) in shapes.items()})
    specs = {(0, k): (all_ax,) + (None,) * len(s)
             for k, (s, _) in shapes.items()}
    specs[(1,)] = (None, None, None)
    return (cfg, functools.partial(_retrieve_sharded, ecfg),
            (index, _meta((qb, ecfg.n_q, d), f32)), specs)


def _retrieve_sharded(ecfg, index_stacked, queries):
    """The sharded plan: on real tensors
    ``serve.make_shardmap_retriever`` over the default process group (one
    rank per shard); on meta one device's program at one shard's shapes,
    ``serve._local_retrieve``'s pipeline with its all-gather's (B, S·k)
    result and the second top-k."""
    from ..core import engine
    from ..core.topk import topk
    from . import serve

    if not queries.is_meta:
        run = serve.make_shardmap_retriever(None, ecfg, device=queries.device)
        return run(index_stacked, queries)
    n_shards = index_stacked.codes.shape[0]
    local = serve._shard(index_stacked, 0)
    qm = torch.ones(queries.shape[:2], dtype=torch.bool, device=META)
    res = engine._retrieve_batch(local, queries, ecfg, qm)
    sc = res.scores.repeat(1, n_shards)                 # the all-gather
    gi = res.doc_ids.repeat(1, n_shards)
    top, pos = topk(sc, ecfg.k)
    return engine.RetrievalResult(top, torch.gather(gi, 1, pos))


# ---------------------------------------------------------------------------

def build_cell(arch, shape_name: str, mesh: Mesh) -> Cell:
    """The cell (``arch`` a registry name or an ``ArchSpec``) on
    ``mesh``."""
    spec = registry.get(arch) if isinstance(arch, str) else arch
    build = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
             "retrieval": _retrieval_cell}.get(spec.family)
    if build is None:
        raise ValueError(spec.family)
    cfg, fn, args, specs = build(spec, shape_name, mesh)
    cell = spec.shapes[shape_name]
    return Cell(fn, args, specs, spec, shape_name, spec.family,
                cell.kind, cfg, dict(cell.dims), cell.grad_accum, mesh)


def donate_argnums(arch: str, shape_name: str) -> tuple:
    """Buffer donation: train steps alias state in->out; decode aliases the
    KV cache (the port's steps update both in place)."""
    kind = registry.get(arch).shapes[shape_name].kind
    if kind in ("train", "train_sampled"):
        return (0,)
    if kind == "decode":
        return (1,)
    return ()

