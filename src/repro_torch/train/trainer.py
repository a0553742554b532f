"""Fault-tolerant training loop (counterpart of ``repro/train/trainer.py``).

  * gradient accumulation over microbatches, losses and gradients summed in
    microbatch order in float32, as the reference's ``lax.scan``;
  * optional int8 gradient compression round trip, and the gradient norm;
  * periodic and SIGTERM-safe checkpoints in the reference's format and
    tree (``{"params": ..., "opt": ...}``, train/checkpoint.py), resumed
    from the latest with a deterministic data skip (batches are a function
    of the step);
  * a straggler watch: steps slower than ``straggler_factor`` times the
    wall-time EWMA are counted and handed to ``on_straggler``.

Unlike the reference, ``run`` puts the SIGTERM handler it replaced back
when it returns, so a process that trains and then serves keeps its own.

The parameters are a module (a ``Transformer``, a recommender or the GCN)
that the step updates in place; the optimizer sees them, their gradients
and its state in the reference's layout (``models.to_reference_layout``,
each model by its own rule). A model whose tree holds integer leaves (DLRM's
PQ codes) is refused with ``TypeError``, as ``jax.value_and_grad`` refuses
it in the reference. The step's products run under ``exact_matmuls`` (TF32
off), and on the card in a fixed order: the continuous run and a resumed one
give the same bits.
"""
from __future__ import annotations

import copy
import dataclasses
import signal
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from .. import tree
from ..core.precision import exact_matmuls
from ..device import resolve_device
from ..models import (flat, load_reference_layout, params_to_reference,
                      reference_leaves, to_reference_layout)
from . import checkpoint as ckpt_lib
from .compression import compress_tree
from .optimizer import Optimizer, state_from_reference, state_to_reference


class TrainState(NamedTuple):
    """The step count, the parameters (a module) and the optimizer's
    state."""

    step: int
    params: nn.Module
    opt_state: Any


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The reference's ``TrainerConfig`` (``trainer.py:37``)."""

    grad_accum: int = 1
    compress_grads: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    ckpt_chunks: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0


def _value_and_grad(loss_fn: Callable, model: nn.Module, batch) -> tuple:
    """(loss, gradients in the reference's layout); a parameter the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it. Integer
    leaves raise ``TypeError``, as ``jax.grad`` does on them."""
    ints = flat.integer_leaves(model)
    if ints:
        raise TypeError(f"grad requires floating-point leaves, but the "
                        f"model's tree holds integer ones: {ints[:3]}")
    params = list(model.parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return loss.detach(), to_reference_layout(model, grads)


def _microbatch(batch, i: int):
    if isinstance(batch, dict):
        return {k: _microbatch(v, i) for k, v in batch.items()}
    return batch[i]


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    cfg: TrainerConfig,
                    micro_param_layout: Optional[Callable] = None
                    ) -> Callable:
    """``loss_fn(model, batch) -> scalar`` -> the step ``(state, batch) ->
    (state, metrics)`` (ref ``trainer.py:48``), which updates
    ``state.params`` in place. With ``grad_accum > 1`` every leaf of
    ``batch`` has a leading (grad_accum, ...) microbatch axis.

    ``micro_param_layout``: an optional params -> params transform applied
    once before the microbatch loop (the reference hoists the FSDP weight
    gather out of the loop with it); the microbatches' gradients are taken
    on what it returns, a module with the same parameters in the same
    order, and accumulate and update ``state.params``."""

    def compute_grads(model, batch):
        if cfg.grad_accum == 1:
            return _value_and_grad(loss_fn, model, batch)
        pfull = micro_param_layout(model) if micro_param_layout else model
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(model.parameters()).device)
        gsum = tree.map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), to_reference_layout(model))
        for i in range(cfg.grad_accum):
            loss, g = _value_and_grad(loss_fn, pfull, _microbatch(batch, i))
            loss_sum = loss_sum + loss
            gsum = tree.map_leaves(torch.add, gsum, g)
        inv = 1.0 / cfg.grad_accum
        return loss_sum * inv, tree.map_leaves(lambda g: g * inv, gsum)

    def train_step(state: TrainState, batch) -> tuple:
        with exact_matmuls():
            loss, grads = compute_grads(state.params, batch)
            if cfg.compress_grads:
                grads = compress_tree(grads)
            new_params, new_opt = optimizer.update(
                grads, state.opt_state, to_reference_layout(state.params))
            load_reference_layout(state.params, new_params)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
        return (TrainState(state.step + 1, state.params, new_opt),
                {"loss": loss, "grad_norm": gnorm})

    return train_step


def _blank(state: Any) -> Any:
    """An optimizer state's reference tree with None leaves."""
    if isinstance(state, torch.Tensor):
        return None
    out = {k: _blank(v) for k, v in state.items()}
    if out and all(isinstance(k, tuple) for k in out):
        return tree.nest(out)
    return out


def _to(batch, device):
    if isinstance(batch, dict):
        return {k: _to(v, device) for k, v in batch.items()}
    return batch.to(device) if isinstance(batch, torch.Tensor) else batch


class Trainer:
    """The training loop (ref ``trainer.py:95``) on
    ``resolve_device(device)``. ``init_params`` (a module) is copied there,
    so trainers made from one module start alike; ``make_batch(step)``
    gives the step's batch (moved to the device)."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 make_batch: Callable[[int], Any], cfg: TrainerConfig,
                 init_params: nn.Module,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.optimizer = optimizer
        self.make_batch = make_batch
        self.on_straggler = on_straggler
        self.step_fn = make_train_step(loss_fn, optimizer, cfg)
        params = copy.deepcopy(init_params).to(self.device)
        self.state = TrainState(0, params, optimizer.init(
            to_reference_layout(params)))
        self._stop = False
        self.metrics_log: list[dict] = []
        self.straggler_steps = 0

    # -- fault tolerance -----------------------------------------------------
    def _install_sigterm(self):
        """Route SIGTERM to a stop flag -> the handler it replaced (None
        when it could not be installed: not the main thread)."""
        def handler(signum, frame):
            self._stop = True  # finish the current step, checkpoint, exit
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None

    def _tree(self) -> dict:
        return {"params": params_to_reference(self.state.params),
                "opt": state_to_reference(self.state.opt_state)}

    def _structure(self) -> dict:
        """The checkpoint tree's structure, its leaves None (what
        ``checkpoint.restore`` reads of its template), without copying the
        state to the host."""
        params = reference_leaves(self.state.params)
        return {"params": tree.nest(dict.fromkeys(params)),
                "opt": _blank(self.state.opt_state)}

    def save(self):
        """Checkpoint the state at its step (nothing without a
        ``ckpt_dir``)."""
        if self.cfg.ckpt_dir is None:
            return
        ckpt_lib.save(self.cfg.ckpt_dir, self._tree(), int(self.state.step),
                      n_chunks=self.cfg.ckpt_chunks)

    def maybe_resume(self) -> int:
        """Load the latest checkpoint, if any, into the state -> its
        step (0 without one)."""
        if self.cfg.ckpt_dir is None:
            return 0
        if ckpt_lib.latest_step(self.cfg.ckpt_dir) is None:
            return 0
        saved, step = ckpt_lib.restore(self.cfg.ckpt_dir, self._structure())
        params = self.state.params
        load_reference_layout(params, tree.flatten(saved["params"]))
        opt = state_from_reference(saved["opt"], self.state.opt_state)
        self.state = TrainState(step, params, opt)
        return step

    # -- main loop -----------------------------------------------------------
    def run(self, n_steps: int) -> dict:
        """Train to step ``n_steps`` from the latest checkpoint (or 0);
        stop early, with a checkpoint, once SIGTERM arrived. The process'
        own SIGTERM handler is back in place when it returns."""
        prev = self._install_sigterm()
        try:
            return self._run(n_steps)
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)

    def _run(self, n_steps: int) -> dict:
        start = self.maybe_resume()   # deterministic skip: batches by step
        ewma = None
        for step in range(start, n_steps):
            if self._stop:
                break
            batch = _to(self.make_batch(step), self.device)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.cfg.straggler_factor * ewma and step > start + 2:
                self.straggler_steps += 1
                if self.on_straggler:
                    self.on_straggler(step, dt)
            metrics.update(step=step + 1, sec=dt)
            if (step + 1) % self.cfg.log_every == 0 or step == n_steps - 1:
                self.metrics_log.append(metrics)
            if self.cfg.ckpt_dir and (step + 1) % self.cfg.ckpt_every == 0:
                self.save()
        if self._stop:
            self.save()
        return {"final_step": int(self.state.step),
                "interrupted": self._stop,
                "stragglers": self.straggler_steps,
                "log": self.metrics_log}
