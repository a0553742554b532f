"""MIND x EMVB on the PyTorch port: the paper's technique on the recommender
where it applies directly (a MIND user IS a multi-vector query of n_q = 4
interest capsules; candidate scoring IS late interaction). The counterpart
of ``examples/mind_emvb_retrieval.py``, on the card unless asked otherwise:

    PYTHONPATH=src python examples/mind_emvb_retrieval_torch.py
    PYTHONPATH=src python examples/mind_emvb_retrieval_torch.py --device cpu

Trains MIND in-batch, builds an EMVB index over the item table (one token
per item: centroids + PQ m = 16), then serves each user's 4 interests two
ways, exact brute-force MaxSim and the EMVB engine on its fused kernel lane
(bit-vector prefilter over 4-bit words, then PQ late interaction with
``th_r=None``), and reports their top-10 overlap, score quality and speed.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import EngineConfig, build_index, engine
from repro_torch.core.topk import topk
from repro_torch.device import resolve_device
from repro_torch.models.recsys import mind
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import Trainer, TrainerConfig

ENGINE = dict(n_q=4, k=10, nprobe=32, th=0.3, th_r=None, n_filter=4096,
              n_docs=1024)
WINDOW = 64        # a user's history lies in a window of neighbouring items


def make_batch_fn(n_items: int, seq_len: int, batch: int = 64):
    """step -> a batch of users whose histories cluster around an anchor
    item (popularity neighbourhoods), the target the window's middle."""
    def make(step: int):
        g = torch.Generator()
        g.manual_seed(int(step))
        anchor = torch.randint(0, n_items - WINDOW, (batch, 1), generator=g)
        hist = anchor + torch.randint(0, WINDOW, (batch, seq_len),
                                      generator=g)
        return {"hist_items": hist.to(torch.int32),
                "hist_valid": torch.ones((batch, seq_len), dtype=torch.bool),
                "target_item": ((anchor[:, 0] + WINDOW // 2) % n_items
                                ).to(torch.int32)}
    return make


def quality(exact: torch.Tensor, exact_top: torch.Tensor,
            emvb_top: torch.Tensor, k: int = 10) -> tuple:
    """(mean top-k overlap of EMVB with exact, mean exact score of EMVB's
    top-k over that of exact's): near-duplicate items make strict overlap
    tie-dominated, the score ratio is the tie-robust measure."""
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(
        exact_top.tolist(), emvb_top.tolist())])
    got = torch.gather(exact, 1, emvb_top.long()).mean(1)
    best = torch.gather(exact, 1, exact_top.long()).mean(1)
    return float(overlap), float((got / best).mean())


def main(n_items: int = 20_000, n_centroids: int = 512, steps: int = 60,
         n_users: int = 64, device=None) -> dict:
    """Train ``steps`` steps over ``n_items`` items, index them at
    ``n_centroids`` centroids, serve ``n_users`` users -> the losses, the
    overlap and score ratio, and both top-10s."""
    dev = resolve_device(device)
    cfg = mind.MINDConfig(name="mind-demo", vocab_items=n_items,
                          embed_dim=64, n_interests=4, capsule_iters=3,
                          seq_len=32)
    make_batch = make_batch_fn(n_items, cfg.seq_len)
    print(f"training MIND (in-batch sampled softmax) on {dev} ...")
    tr = Trainer(lambda p, b: mind.loss_fn(p, b, cfg),
                 opt_lib.make("adamw", lr=1e-2), make_batch,
                 TrainerConfig(log_every=10), mind.init_params(0, cfg, dev),
                 device=dev)
    out = tr.run(steps)
    print(f"  final loss {out['log'][-1]['loss']:.4f}")
    params = tr.state.params

    # ---- the item corpus as a multi-vector index (1 token per item) -------
    with torch.no_grad():
        items = params.item_emb.detach()
        items = items / torch.clamp(torch.linalg.vector_norm(
            items, dim=-1, keepdim=True), min=1e-9)
    print(f"indexing {n_items} items (EMVB: {n_centroids} centroids + PQ "
          "m=16) ...")
    index, _ = build_index(1, items.cpu().numpy()[:, None, :],
                           np.ones(n_items, np.int32),
                           n_centroids=n_centroids, m=16, nbits=8,
                           kmeans_iters=4, device=dev)

    # ---- user interests = the multi-vector queries -------------------------
    batch = {k: v[:n_users].to(dev)
             for k, v in make_batch_fn(n_items, cfg.seq_len,
                                       max(n_users, 64))(999).items()}
    with torch.no_grad():
        q = mind.user_interests(params, batch["hist_items"],
                                batch["hist_valid"], cfg)     # (B, 4, D)

        def exact_fn():
            return mind.score_candidates(q, items)
        exact_fn()                                 # warm up
        _sync(dev)
        t0 = time.perf_counter()
        exact = exact_fn()
        exact_top = topk(exact, 10)[1]
        _sync(dev)
        t_exact = time.perf_counter() - t0

        ecfg = EngineConfig(**ENGINE, use_kernels=True)
        engine.retrieve(index, q, ecfg, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        res = engine.retrieve(index, q, ecfg, device=dev)
        _sync(dev)
        t_emvb = time.perf_counter() - t0
    overlap, ratio = quality(exact, exact_top, res.doc_ids)
    print(f"\nexact MaxSim : {t_exact / n_users * 1e3:6.3f} ms/user")
    print(f"EMVB engine  : {t_emvb / n_users * 1e3:6.3f} ms/user")
    print(f"top-10 overlap vs exact : {overlap * 100:.0f}%")
    print(f"score quality (EMVB top-10 / exact top-10): {ratio * 100:.1f}%")
    return {"losses": [m["loss"] for m in out["log"]], "overlap": overlap,
            "score_ratio": ratio, "exact_top": exact_top.cpu(),
            "emvb_top": res.doc_ids.cpu(), "emvb_scores": res.scores.cpu()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=20_000)
    ap.add_argument("--centroids", type=int, default=512)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (default: the card)")
    a = ap.parse_args()
    main(a.items, a.centroids, a.steps, device=a.device)
