"""Training launcher (counterpart of ``repro/launch/train.py``): trains the
smoke variant of any ``--arch`` of the registry on synthetic data, on the
card unless ``--device cpu``, with the arch's optimizer, gradient
accumulation, checkpoints, resume and the straggler count.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mind --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
        --device cpu

Batches are a function of the step: each is drawn from a CPU
``torch.Generator`` seeded with it (the reference uses ``jax.random``, so
the draws differ) and moved to the trainer's device.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import registry
from ..device import resolve_device
from ..train import optimizer as opt_lib
from ..train.trainer import Trainer, TrainerConfig


def _gen(step: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(int(step))
    return g


def _randint(g, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)


def lm_batch_fn(vocab: int, batch: int = 8, seq: int = 64):
    """step -> {tokens, labels} (B, S), the labels the tokens."""
    def make(step: int):
        toks = _randint(_gen(step), 0, vocab, (batch, seq))
        return {"tokens": toks, "labels": toks}
    return make


def gnn_batch_fn(cfg):
    """step -> a random 64-node, 256-edge graph: feats, edges, edge_mask,
    labels."""
    def make(step: int):
        g = _gen(step)
        n, e = 64, 256
        return {
            "feats": torch.randn((n, cfg.d_feat), generator=g),
            "edges": _randint(g, 0, n, (2, e)),
            "edge_mask": torch.ones((e,), dtype=torch.bool),
            "labels": _randint(g, 0, cfg.n_classes, (n,)),
        }
    return make


def recsys_batch_fn(arch: str, cfg, batch: int = 32):
    """step -> a batch of ``arch``'s inputs, every history and multi-hot
    slot valid."""
    def make(step: int):
        g = _gen(step)
        ones = dict(dtype=torch.bool)
        if arch in ("dlrm-mlperf", "dcn-v2"):
            v = min(cfg.vocab_sizes)
            shape = (batch, cfg.n_sparse, cfg.nnz)
            return {
                "dense": torch.randn((batch, cfg.n_dense), generator=g),
                "sparse_idx": _randint(g, 0, v, shape),
                "sparse_valid": torch.ones(shape, **ones),
                "labels": _randint(g, 0, 2, (batch,)),
            }
        if arch == "dien":
            shape = (batch, cfg.seq_len)
            return {
                "hist_items": _randint(g, 0, cfg.vocab_items, shape),
                "hist_cats": _randint(g, 0, cfg.vocab_cats, shape),
                "hist_valid": torch.ones(shape, **ones),
                "target_item": _randint(g, 0, cfg.vocab_items, (batch,)),
                "target_cat": _randint(g, 0, cfg.vocab_cats, (batch,)),
                "labels": _randint(g, 0, 2, (batch,)),
            }
        if arch == "mind":
            shape = (batch, cfg.seq_len)
            return {
                "hist_items": _randint(g, 0, cfg.vocab_items, shape),
                "hist_valid": torch.ones(shape, **ones),
                "target_item": _randint(g, 0, cfg.vocab_items, (batch,)),
            }
        raise ValueError(arch)
    return make


def _recsys_model(arch: str):
    """The model module of a recommender arch (ref
    ``launch/steps.py:256``)."""
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


def build_smoke_trainer(arch: str, ckpt_dir=None, steps_per_ckpt: int = 50,
                        grad_accum: int = 1, device=None) -> Trainer:
    """A :class:`~repro_torch.train.trainer.Trainer` of ``arch``'s smoke
    config on ``resolve_device(device)``: weights from seed 0, the arch's
    optimizer, its family's batches."""
    dev = resolve_device(device)
    spec = registry.get(arch)
    cfg = spec.make_smoke_config()
    tcfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=steps_per_ckpt,
                         log_every=5, grad_accum=grad_accum)
    opt = opt_lib.make(spec.optimizer)

    if spec.family == "lm":
        from ..models import transformer as M
        make_batch = lm_batch_fn(cfg.vocab)
    elif spec.family == "gnn":
        from ..models import gcn as M
        make_batch = gnn_batch_fn(cfg)
    elif spec.family == "recsys":
        M = _recsys_model(arch)
        make_batch = recsys_batch_fn(arch, cfg)
    else:
        raise ValueError(f"no training path for family {spec.family}")
    params = M.init_params(0, cfg, dev)

    def loss(p, b):
        return M.loss_fn(p, b, cfg)

    if grad_accum > 1:
        inner = make_batch

        def make_batch(step):  # noqa: F811
            mbs = [inner(step * grad_accum + i) for i in range(grad_accum)]
            return {k: torch.stack([mb[k] for mb in mbs]) for k in mbs[0]}

    return Trainer(loss, opt, make_batch, tcfg, params, device=dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (default: the card)")
    args = ap.parse_args(argv)
    tr = build_smoke_trainer(args.arch, args.ckpt_dir,
                             grad_accum=args.grad_accum, device=args.device)
    out = tr.run(args.steps)
    for m in out["log"]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['sec']*1e3:.0f}ms")
    print(f"done at step {out['final_step']} "
          f"(interrupted={out['interrupted']}, stragglers={out['stragglers']})")


if __name__ == "__main__":
    main()
