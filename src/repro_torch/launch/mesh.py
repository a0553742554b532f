"""Production mesh definition (counterpart of ``repro/launch/mesh.py``).

A mesh here is logical only: a frozen record of axis names and sizes that
the sharding rules (``repro_torch/sharding``), the cell builders
(``launch/steps.py``) and the dry run (``launch/dryrun.py``) reckon with. It
holds no devices and never creates a process group; the runs on a card use
``single_card_mesh()``, on which every spec is the whole tensor.

Mesh geometry, the reference's two production shapes:
  single pod : (16, 16)        axes ("data", "model")
  multi-pod  : (2, 16, 16)     axes ("pod", "data", "model")
"pod" is an outer data axis.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes, outermost first."""

    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} "
                             "differ in length")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def name(self) -> str:
        """The sizes joined by ``x``: ``16x16``, ``2x16x16``."""
        return "x".join(str(s) for s in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def single_card_mesh() -> Mesh:
    """One card: (1, 1) over ("data", "model")."""
    return Mesh(("data", "model"), (1, 1))


def data_axes(mesh: Mesh) -> tuple:
    """Axes that carry the batch (everything except 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def fsdp_axes(mesh: Mesh):
    """Axis (tuple) used for FSDP sharding of params/optimizer state."""
    ax = data_axes(mesh)
    return ax if len(ax) > 1 else ax[0]


def n_devices(mesh: Mesh) -> int:
    return math.prod(mesh.axis_sizes)
