"""The PyTorch port end to end: train a ColBERT-style multi-vector
encoder (optionally with JMPQ, straight-through PQ during training, Fang et
al. 2022), encode a corpus with it, index the embeddings with EMVB and
retrieve, scored by MRR@10 against exact MaxSim. The counterpart of
``examples/train_colbert.py``, on the card unless asked otherwise:

    PYTHONPATH=src python examples/train_colbert_torch.py --steps 200 [--jmpq]
    PYTHONPATH=src python examples/train_colbert_torch.py --device cpu

With ``--ckpt-dir`` the trainer checkpoints every 100 steps and a second
run resumes from the latest checkpoint.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import build_index, engine, interaction
from repro_torch.core.pq import train_pq
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import colbert
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import Trainer, TrainerConfig

VOCAB = 1000
N_TOPICS = 32
WORDS_PER_TOPIC = 24
SEQ, Q_LEN = 24, 12
ENGINE = dict(n_q=Q_LEN, k=10, n_filter=128, n_docs=32, th=0.2, th_r=0.3)


def exact_top(queries: torch.Tensor, doc_embs: torch.Tensor,
              doc_valid: torch.Tensor, k: int) -> np.ndarray:
    """The top-``k`` docs of each query by exact MaxSim over the whole
    corpus, one query at a time (``interaction.maxsim``) -> (n, k) ids."""
    return np.stack([torch.topk(interaction.maxsim(q, doc_embs, doc_valid),
                                k).indices.cpu().numpy() for q in queries])


def main(steps: int = 200, n_docs: int = 512, jmpq: bool = False,
         device=None, ckpt_dir=None, n_queries: int = 32) -> dict:
    """Train ``steps`` steps, encode ``n_docs`` passages and ``n_queries``
    planted queries, build the index, retrieve -> the losses, both MRR@10s
    and the embeddings (as numpy) they were measured on."""
    dev = resolve_device(device)
    cfg = colbert.make_config(n_layers=2, d_model=128, n_heads=4, d_head=32,
                              d_ff=256, vocab=VOCAB, out_dim=64)
    model = colbert.ColBERT(cfg, seed=0, device=dev)
    make_batch = synthetic.token_pairs(
        1000, n_topics=N_TOPICS, words_per_topic=WORDS_PER_TOPIC,
        vocab=VOCAB, batch=16, q_len=Q_LEN, d_len=SEQ)

    pq_cb = None
    if jmpq:
        # seed the codebooks from the untrained encoder's embeddings; the
        # straight-through loss then co-adapts encoder and quantizer
        probe = make_batch(0)
        with torch.no_grad():
            de = model(probe["d_tokens"].to(dev), probe["d_valid"].to(dev))
        pq_cb = train_pq(0, de.reshape(-1, de.shape[-1]), m=8, nbits=4,
                         device=dev).codebooks

    def loss(p, b):
        return colbert.contrastive_loss(p, b, cfg, pq_codebooks=pq_cb)

    trainer = Trainer(loss, opt_lib.make("adamw", lr=3e-3), make_batch,
                      TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=100,
                                    log_every=25), model, device=dev)
    print(f"training {steps} steps (jmpq={jmpq}) on {dev} ...")
    t0 = time.time()
    out = trainer.run(steps)
    for m in out["log"]:
        print(f"  step {m['step']:4d}  loss {m['loss']:.4f}")
    print(f"trained in {time.time() - t0:.0f}s")

    # ---- index the corpus with the trained encoder and retrieve ----------
    print(f"encoding + indexing a {n_docs}-doc corpus ...")
    tokens, lens = synthetic.token_corpus(
        7, n_docs=n_docs, n_topics=N_TOPICS, words_per_topic=WORDS_PER_TOPIC,
        vocab=VOCAB, cap=SEQ, min_len=SEQ)
    q_tokens, q_valid, gt = synthetic.token_queries(
        8, tokens, lens, n_queries=n_queries, q_len=Q_LEN, vocab=VOCAB)
    d_valid = torch.from_numpy(np.arange(SEQ)[None] < lens[:, None]).to(dev)
    encoder = trainer.state.params
    with torch.no_grad():
        de = encoder(torch.from_numpy(tokens).to(dev), d_valid)
        qe = encoder(torch.from_numpy(q_tokens).to(dev),
                     torch.from_numpy(q_valid).to(dev))
    index, _ = build_index(1, de.cpu().numpy(), lens, n_centroids=256, m=8,
                           nbits=4, kmeans_iters=4, device=dev)
    ecfg = engine.EngineConfig(**ENGINE, use_kernels=True)
    ids = engine.retrieve(index, qe, ecfg, device=dev).doc_ids.cpu().numpy()
    # exact MaxSim: isolates encoder quality from engine recall
    ids_exact = exact_top(qe, de, d_valid, 10)
    mrr, mrr_exact = (synthetic.mrr_at_k(i, gt) for i in (ids, ids_exact))
    print(f"retrieval over trained embeddings: mrr@10={mrr:.3f} (EMVB) vs "
          f"{mrr_exact:.3f} (exact MaxSim) — planted gt")
    return {"losses": [m["loss"] for m in out["log"]], "mrr_emvb": mrr,
            "mrr_exact": mrr_exact, "doc_embs": de.cpu().numpy(),
            "doc_lens": lens, "queries": qe.cpu().numpy(), "gt": gt}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n-docs", type=int, default=512)
    ap.add_argument("--jmpq", action="store_true",
                    help="STE-PQ during training (JMPQ reproduction)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(args.steps, args.n_docs, args.jmpq, args.device, args.ckpt_dir)
