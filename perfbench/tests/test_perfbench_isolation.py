"""What the benchmark may load: nothing of JAX or of the JAX package
anywhere under ``perfbench/``, and nothing of the program in the plain
reference. Import names are compared by their top-level part, whole: the
port ``repro_torch`` is not the JAX package ``repro``."""
import ast
import os

import pytest

from conftest import PERFBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PERFBENCH, sub)):
        if os.sep + "out" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PERFBENCH))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("references")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "contextlib", "numpy", "torch"}, tops


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.core.engine", "numpy"], []),
    (["repro.core.engine", "repro_torch"], ["repro"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_top_level_names_compare_whole(names, found):
    from harness import runner
    assert runner.forbidden_modules(names) == found
