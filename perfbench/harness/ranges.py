"""``torch.profiler.record_function`` ranges around named functions of the
program, installed from the harness's own code for a traced run.

A range is named by a label and found by a target ``"module:attribute"``:
the attribute is replaced by a wrapper that opens the range and calls the
original, and put back afterwards. The program calls these functions
through their modules (``engine.centroid_scores``, ``bitvector.…``,
``ops.…``), so the wrapper is what it runs. A target that does not exist
is reported missing, and the metrics that read it read nothing.
"""
from __future__ import annotations

import functools
import importlib


def _wrap(fn, label: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def ranged(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return ranged


class Ranges:
    """Installed ranges; :meth:`close` restores every original."""

    def __init__(self, targets: dict):
        self.saved, self.missing = [], set()
        for label, target in sorted(targets.items()):
            mod_name, attr = target.split(":")
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                self.missing.add(label)
                continue
            fn = getattr(mod, attr, None)
            if not callable(fn):
                self.missing.add(label)
                continue
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, _wrap(fn, label))

    def close(self) -> None:
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved = []
