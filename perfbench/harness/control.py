"""The control of the check: the plain reference computed in the nearest
precision below the one the configuration states (TF32 products for
float32 with TF32 off), put in the program's place. Its numbers have to
fail the cell's limits, and the limits are set between the program's
readings and the control's (``PERF.md``)."""
from __future__ import annotations

from . import check, planted, traffic


def control_numbers(cell, seed: int, device, n_batches: int) -> dict:
    """The check's numbers for the control on ``n_batches`` batches of
    the cell's traffic at ``seed``, each against the float32 reference."""
    cfg, mix = cell.config, cell.traffic
    widths = {k: cfg[k] for k in ("n_docs", "cap", "min_len", "d",
                                  "n_centroids", "m", "nbits")}
    data = planted.make_data(traffic.sub_seed(seed, traffic.DATA),
                             device=device, **widths)
    seconds = n_batches / mix["pool_batches_per_s"]
    tf = traffic.make(mix, data, seed, seconds, cfg["engine"]["n_q"])
    ref = cell.reference.Reference(data, tf.plane, cfg)
    low = cell.reference.Reference(data, tf.plane, cfg, precision="tf32")
    served, refs = [], []
    fails = None if tf.filters is None else []
    for i in range(n_batches):
        pred = None if tf.filters is None else tf.filters[i]
        out = low.run(tf.batches[i], pred)
        served.append((out["scores"], out["ids"]))
        refs.append(ref.run(tf.batches[i], pred, score_ids=out["ids"]))
        if fails is not None:
            dp = ref.doc_pass(pred).cpu()
            fails.append(~dp[out["ids"].long()])
    return check.numbers(served, refs, fails)
