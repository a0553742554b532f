"""Optimizers as (init, update) pairs (counterpart of
``repro/train/optimizer.py``), following the reference's formulas, not
``torch.optim``'s (its AdamW, for one, has ``b2 = 0.95`` and applies
``p - lr·(m̂/(√v̂+eps) + wd·p)``, which rounds otherwise).

  adamw     — the default for the dense encoder and LM.
  adagrad   — one float32 accumulator.
  adafactor — factored second moments over the trailing two axes.
  muon      — momentum + Newton–Schulz orthogonalization of >=2-D leaves.

Parameters, gradients and states are flat ``{path: tensor}`` dicts in the
reference's layout and leaf order (``transformer.to_reference_layout``: the
layer leaves stacked on a leading axis), so a leaf's reductions (adafactor's
RMS clip, muon's Frobenius norm) span the same elements as the reference's.
``update`` returns new tensors and changes none of its arguments.
:func:`state_to_reference` and :func:`state_from_reference` convert a state
to the reference's tree and back, leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from .. import tree

_map = tree.map_leaves


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (new_params, new_state)``."""

    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], Tuple[dict, Any]]


def _zeros(params: dict, dtype=torch.float32) -> dict:
    return _map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device),
                params)


def _count(params: dict) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device: the reference's weakly typed
    Python number once jax has made it float32."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------

def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          state_dtype=torch.float32) -> Optimizer:
    """AdamW (ref ``optimizer.py:33``)."""
    def init(params):
        return {"m": _zeros(params, state_dtype),
                "v": _zeros(params, state_dtype), "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        cf = c.float()
        b1c = 1 - torch.pow(_f32(b1, cf), cf)
        b2c = 1 - torch.pow(_f32(b2, cf), cf)
        m = _map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype),
                 state["m"], grads)
        v = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)),
                 state["v"], grads)

        def upd(p, m, v):
            step = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            p32 = p.float()
            return (p32 - lr * (step + weight_decay * p32)).to(p.dtype)
        return _map(upd, params, m, v), {"m": m, "v": v, "count": c}

    return Optimizer(init, update)


def adagrad(lr: float = 1e-2, eps: float = 1e-10) -> Optimizer:
    """Adagrad (ref ``optimizer.py:61``)."""
    def init(params):
        return {"acc": _zeros(params)}

    def update(grads, state, params):
        acc = _map(lambda a, g: a + torch.square(g.float()), state["acc"],
                   grads)
        new = _map(lambda p, g, a: (p.float() - lr * g.float() /
                                    (torch.sqrt(a) + eps)).to(p.dtype),
                   params, grads, acc)
        return new, {"acc": acc}

    return Optimizer(init, update)


def adafactor(lr: float = 1e-2, eps: float = 1e-30, decay: float = 0.8,
              clip_rms: float = 1.0) -> Optimizer:
    """Factored second moments for >=2-D leaves (row and column
    accumulators over the trailing two axes), a full accumulator otherwise
    (ref ``optimizer.py:79``)."""
    def init(params):
        def one(p):
            if p.ndim >= 2:
                return {"row": torch.zeros(p.shape[:-1], device=p.device),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           device=p.device)}
            return {"full": torch.zeros(p.shape, device=p.device)}
        return {"v": _map(one, params), "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        beta = 1.0 - torch.pow(c.float(), -decay)
        new_p, new_v = {}, {}
        for k, g in grads.items():
            p, v = params[k], state["v"][k]
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if g.ndim >= 2:
                row = beta * v["row"] + (1 - beta) * g2.mean(dim=-1)
                col = beta * v["col"] + (1 - beta) * g2.mean(dim=-2)
                denom = (row[..., None] / torch.clamp(
                    row.mean(dim=-1, keepdim=True)[..., None], min=eps)) * \
                    col[..., None, :]
                upd = g32 * torch.rsqrt(torch.clamp(denom, min=eps))
                new_v[k] = {"row": row, "col": col}
            else:
                full = beta * v["full"] + (1 - beta) * g2
                upd = g32 * torch.rsqrt(torch.clamp(full, min=eps))
                new_v[k] = {"full": full}
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-12)
            upd = upd / torch.clamp(rms / clip_rms, min=1.0)
            new_p[k] = (p.float() - lr * upd).to(p.dtype)
        return new_p, {"v": new_v, "count": c}

    return Optimizer(init, update)


def _newton_schulz(g: torch.Tensor, steps: int = 5,
                   dtype=torch.float32) -> torch.Tensor:
    """Orthogonalize a 2-D matrix by the quintic Newton–Schulz iteration
    (ref ``optimizer.py:127``), normalized by its Frobenius norm in
    float32."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g.float()
    transpose = x.shape[0] > x.shape[1]
    if transpose:
        x = x.T
    x = (x / (torch.linalg.norm(x) + 1e-7)).to(dtype)
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.T if transpose else x


def muon(lr: float = 0.02, momentum: float = 0.95, ns_steps: int = 5,
         adamw_lr: float = 3e-4, state_dtype=torch.float32,
         mats_spec=None, ns_dtype=torch.float32) -> Optimizer:
    """Muon for >=2-D leaves, an SGD-momentum step with ``adamw_lr`` for
    vectors and scalars (ref ``optimizer.py:144``). A stacked leaf's
    leading axes are batch axes: Newton–Schulz runs on each of its
    matrices in turn, as the reference's ``lax.map`` over the layer axis.
    Note that the stacked norm scales (n_layers, d) are 2-D there, and so
    matrices here too. ``mats_spec`` (shape -> spec or None) is the
    reference's sharding hook for the matrices: one process holds them
    whole, so it changes no number and is not called."""
    def init(params):
        return {"mu": _zeros(params, state_dtype), "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        mu = _map(lambda m, g: momentum * m + g.to(m.dtype), state["mu"],
                  grads)

        def upd(p, m):
            if p.ndim >= 2:
                mats = m.reshape(-1, *m.shape[-2:])
                o = torch.stack([_newton_schulz(x, ns_steps, ns_dtype)
                                 for x in mats]).reshape(m.shape)
                scale = torch.sqrt(_f32(max(1.0, m.shape[-2] / m.shape[-1]),
                                        m))
                return (p.float() - lr * scale * o.float()).to(p.dtype)
            return (p.float() - adamw_lr * m.float()).to(p.dtype)
        return _map(upd, params, mu), {"mu": mu, "count": c}

    return Optimizer(init, update)


REGISTRY = {
    "adamw": adamw,
    "adagrad": adagrad,
    "adafactor": adafactor,
    "muon": muon,
}


def make(name: str, **kw) -> Optimizer:
    """The optimizer ``name`` of :data:`REGISTRY` (ref
    ``optimizer.py:208``)."""
    return REGISTRY[name](**kw)


# ---------------------------------------------------------------------------
# the reference's state trees
# ---------------------------------------------------------------------------

def state_to_reference(state: Any) -> Any:
    """A state as the reference's tree: nested dicts of numpy arrays (bf16
    leaves as float32), each flat ``{path: ...}`` dict nested."""
    if isinstance(state, torch.Tensor):
        from ..models.transformer import to_numpy
        return to_numpy(state)
    if isinstance(state, dict):
        out = {k: state_to_reference(v) for k, v in state.items()}
        if out and all(isinstance(k, tuple) for k in out):
            return tree.nest(out)
        return out
    raise TypeError(f"optimizer state holds a {type(state).__name__}")


def state_from_reference(ref: Any, like: Any) -> Any:
    """The reference's state tree ``ref`` as a state shaped as ``like``
    (the port's state of the same optimizer over the same parameters), on
    its devices and in its dtypes."""
    if isinstance(like, torch.Tensor):
        from ..models.transformer import as_tensor
        return as_tensor(ref).to(like.device, like.dtype)
    return {k: state_from_reference(
        tree.get(ref, k) if isinstance(k, tuple) else ref[k], v)
        for k, v in like.items()}
