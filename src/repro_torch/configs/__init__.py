"""The architecture registry (counterpart of ``repro/configs``):
``registry.get(name)`` returns the ArchSpec of an ``--arch`` entry."""
from . import registry  # noqa: F401
from .registry import get, names  # noqa: F401
