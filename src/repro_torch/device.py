"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it raises when CUDA is absent, so a caller that
    did not ask for the CPU never silently gets it. Pass ``"cpu"`` (as the
    tests do) to run the plain PyTorch versions of the kernels.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           "available")
    return dev


def resolve_on(where: torch.device, device=None) -> torch.device:
    """:func:`resolve_device`, refusing when the data an entry point was
    given lives on ``where``, another device than the one asked for."""
    dev = resolve_device(device)
    if where.type != dev.type or (dev.index is not None
                                  and where.index != dev.index):
        raise ValueError(f"the index lives on {where} but device={dev} was "
                         "requested; load it there (load_index(..., "
                         "device=...)) first")
    return dev
