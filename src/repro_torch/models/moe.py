"""Mixture-of-experts FFN with top-k routing and per-expert capacity
(counterpart of ``repro/models/moe.py``).

Two dispatch modes, as the reference's. The capacity gather
(:func:`_moe_block_gather`, the configs' default) routes each token to its
``top_k`` experts with renormalized gates, lets each expert take its top-C
tokens by gate, runs the experts' SwiGLU as three batched products over the
(E, C, d) rows and sums the weighted rows back to their tokens. The grouped
dispatch (:func:`moe_block_grouped`, ``cfg.moe_groups`` > 0) splits the
tokens into groups, queues each group's tokens per expert in token order and
dispatches and combines through a (g, t_l, E, C) one-hot, O(T·E·C): it is
meant for small inputs. Tokens over capacity are dropped. Both return the
Switch load-balance loss.

Both top-ks, the token side over the probabilities and the expert side
over the mostly zero (E, T) gate matrix, go through ``core/topk.py::topk``:
lax tie order, so an expert whose capacity exceeds the tokens routed to it
fills up with zero-gate tokens lowest index first, as the reference's.
Rows are gathered by ``flat.take_rows`` and summed back by
``flat.segment_sum`` in the reference's update order (expert-major), never
with atomics: a call gives the same bits every run, on either device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.topk import topk
from .flat import segment_sum, take_rows
from .layers import Experts, ModelConfig


def route(router: torch.Tensor, x: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., d) -> (probs (..., E), gates (..., k), expert ids (..., k)):
    the float32 router's softmax and its top ``k`` experts, the gates
    renormalized to sum to one (ref ``moe.py:106-109``)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    topv, topi = topk(probs, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def gather_capacity(t: int, cfg: ModelConfig) -> int:
    """Tokens an expert takes in the capacity gather over ``t`` tokens:
    round(t·k/E·cf) with Python's round (half to even), in [1, t]
    (ref ``moe.py:116``)."""
    e, k = cfg.n_experts, cfg.top_k
    return int(max(1, min(t, round(t * k / e * cfg.capacity_factor))))


def grouped_capacity(tl: int, cfg: ModelConfig) -> int:
    """Tokens an expert takes from a group of ``tl`` in the grouped
    dispatch: ceil(tl·k/E) · max(1, cf), at most ``tl``
    (ref ``moe.py:58-59``)."""
    e, k = cfg.n_experts, cfg.top_k
    return min(int(max(1, -(-tl * k // e) * max(1.0, cfg.capacity_factor))),
               tl)


def _experts(p: Experts, xd: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its rows: xd (..., E, C, d) -> (..., E, C,
    d), three batched products in ``xd.dtype``."""
    hidden = F.silu(torch.matmul(xd, p.wi_gate)) * torch.matmul(xd, p.wi_up)
    return torch.matmul(hidden, p.wo)


def _aux(probs: torch.Tensor, routed: torch.Tensor, e: int) -> torch.Tensor:
    """The Switch load-balance loss: E · sum over experts of the mean
    probability times the share of tokens routed there."""
    dims = tuple(range(probs.dim() - 1))
    return e * torch.sum(probs.mean(dim=dims) *
                         routed.float().mean(dim=dims))


def moe_block(p: Experts, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar) (ref ``moe.py:28``):
    the grouped dispatch when ``cfg.moe_groups``, else the capacity
    gather."""
    if cfg.moe_groups:
        return moe_block_grouped(p, x, cfg)
    return _moe_block_gather(p, x, cfg)


def moe_block_grouped(p: Experts, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped dispatch (ref ``moe.py:37``): tokens in ``moe_groups``
    groups; in each, an expert takes the first :func:`grouped_capacity`
    tokens routed to it, in token order, through a one-hot (g, t_l, E, C)
    dispatch product, and the gated one-hot combines the experts' rows."""
    b, s, d = x.shape
    g, t = cfg.moe_groups, b * s
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    tl = t // g
    e = cfg.n_experts
    cap = grouped_capacity(tl, cfg)
    xg = x.reshape(g, tl, d)
    probs, topv, topi = route(p.router, xg, cfg.top_k)
    sel = (F.one_hot(topi, e).float() * topv[..., None]).sum(-2)  # (g, tl, E)
    mask = sel > 0
    pos = torch.cumsum(mask.long(), dim=1) - 1
    keep = mask & (pos < cap)
    disp = keep[..., None] & (pos[..., None] == torch.arange(
        cap, device=x.device))                                    # (g,tl,E,C)
    xdisp = torch.einsum("gtec,gtd->gecd", disp.to(cfg.dtype), xg)
    yexp = _experts(p, xdisp)                                     # (g,E,C,d)
    comb = (disp * sel[..., None]).to(cfg.dtype)
    out = torch.einsum("gtec,gecd->gtd", comb, yexp)
    return out.reshape(b, s, d), _aux(probs, mask, e)


def _moe_block_gather(p: Experts, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity gather (ref ``moe.py:98``): each expert takes its top
    :func:`gather_capacity` tokens by gate; the gate-weighted (E·C, d) rows
    are summed back to their tokens expert-major, as the reference's
    scatter-add applies them (zero-gate rows add nothing)."""
    b, s, d = x.shape
    t, e = b * s, cfg.n_experts
    xf = x.reshape(t, d)
    probs, topv, topi = route(p.router, xf, cfg.top_k)
    sel = torch.zeros((t, e), dtype=torch.float32,
                      device=x.device).scatter(1, topi, topv)    # (T, E)
    cap = gather_capacity(t, cfg)
    gw, gidx = topk(sel.T, cap)                                  # (E, C)
    ids = gidx.reshape(-1)
    yexp = _experts(p, take_rows(xf, ids).reshape(e, cap, d))
    yw = yexp * gw[..., None].to(yexp.dtype)
    out = segment_sum(yw.reshape(-1, d), ids, t)
    return out.reshape(b, s, d), _aux(probs, sel > 0, e)
