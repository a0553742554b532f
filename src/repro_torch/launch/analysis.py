"""Roofline analysis of a reckoned cell (counterpart of
``repro/launch/analysis.py``), on the H100's constants:

  compute term    = FLOPs_per_chip / PEAK_FLOPS
  memory term     = HBM_bytes_per_chip / HBM_BW
  collective term = collective_bytes_per_chip / LINK_BW

FLOPs and bytes a chip come from ``launch/op_stats.py``; collective bytes
a chip from the specs, with the standard ring-transfer factors (bytes that
cross a link per device, :func:`collective_link_bytes`, the reference's
``hlo_stats.py:180-190``):

  all-gather       ~ result * (g-1)/g          (device receives the rest)
  all-reduce       ~ 2 * result * (g-1)/g      (reduce-scatter + all-gather)
  reduce-scatter   ~ result * (g-1)
  all-to-all       ~ result * (g-1)/g
  collective-permute ~ result

Hardware model, each constant the NVIDIA H100 SXM datasheet's: 989 TFLOP/s
dense BF16 on the tensor cores, 3.35 TB/s HBM3, and 50 GB/s a GPU for the
collective term, which is one 400 Gb/s NDR InfiniBand port: a 16-wide mesh
axis spans more than one 8-GPU NVLink node, so its rings cross the network.
``HBM_CAPACITY`` is the card's memory as torch reports it
(``torch.cuda.get_device_properties(0).total_memory``), the FITS test of the
dry run.

The reference's ``parse_collectives`` reads optimized HLO text; nothing
here is compiled to HLO, so it has no counterpart: the collectives are
reckoned from the specs instead (``op_stats.collectives``).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12      # H100 SXM datasheet: dense BF16, tensor cores
HBM_BW = 3.35e12         # H100 SXM datasheet: HBM3 bytes/s
LINK_BW = 50e9           # H100 SXM datasheet: NDR InfiniBand, 400 Gb/s
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 (700.00 W), as chip_smoke.py's dryrun phase reads it on the card
HBM_CAPACITY = 85_017_493_504

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_link_bytes(kind: str, nbytes: float, g: int) -> float:
    """Bytes a device sends over its link for one collective of ``kind``
    whose result is ``nbytes``, over a group of ``g`` devices."""
    if kind.startswith("all-gather"):
        return nbytes * (g - 1) / max(g, 1)
    if kind.startswith("all-reduce"):
        return 2.0 * nbytes * (g - 1) / max(g, 1)
    if kind.startswith("reduce-scatter"):
        return float(nbytes) * (g - 1)
    if kind.startswith("all-to-all"):
        return nbytes * (g - 1) / max(g, 1)
    return float(nbytes)  # collective-permute


def roofline(cost: dict, collective_bytes: float,
             model_flops: float | None = None, n_chips: int = 256) -> dict:
    """The three terms, the dominant one and the bound, from ``cost``
    ({"flops", "bytes accessed"} a chip) and the collective bytes a chip;
    with ``model_flops``, the useful-flops ratio and the share of the peak
    a step at the bound would reach."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = collective_bytes / LINK_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    out = {
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_acc,
        "collective_bytes_per_chip": collective_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
    if model_flops is not None and flops > 0:
        out["model_flops_total"] = model_flops
        out["useful_flops_ratio"] = model_flops / (flops * n_chips)
        # fraction of peak the step would hit if it ran at the roofline bound
        out["roofline_fraction"] = (model_flops / n_chips / PEAK_FLOPS) / \
            max(out["bound_s"], 1e-30)
    return out
