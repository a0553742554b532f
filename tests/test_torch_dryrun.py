"""The port's dry run against the reference's, on the CPU.

The reference builds its cells on 512 host devices, so it runs in one
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=512``) that
dumps, for every (cell, mesh) pair, each leaf of ``args``: its path, global
shape, dtype, ``PartitionSpec`` and ``sharding.shard_shape``, and
``donate_argnums``; and, for one smoke-config cell per family on a 2 x 2
mesh of 4 of those devices, ``hlo_stats.analyze`` of the compiled program.

How the port's leaves map onto the reference's: a path's entries are the
reference's dict keys, NamedTuple field names and sequence indices
(``steps.leaves``: a module's parameters in the reference's layout, a
transformer's layers stacked; the port's flat optimizer state nested as the
reference's; ``TrainState.step`` a 0-d int32 tensor as the reference's).
dtypes compare by name (``torch.bfloat16`` -> ``bfloat16``; ``pred_words``
is ``uint32`` in both packages, and the retrieval cell's ``plaid_res`` is
the reference's (1, 1, 1) placeholder in both). A spec compares entry by
entry as tuples of axis names, trailing whole dimensions written out
(``P(a)`` is ``P(a, None)``).
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.launch import analysis as ranalysis
from repro.launch import hlo_stats as rhlo
from repro.launch import modelflops as rmf
from repro.sharding import rules as rrules
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch import analysis, dryrun, op_stats, steps
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.modelflops import model_flops
from repro_torch.models import to_reference_layout
from repro_torch.models import transformer as T
from repro_torch.sharding import rules
from repro_torch.sharding.rules import axes_of, shard_shape

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CELLS = [(a, s, m) for m in ("single", "multi") for a in registry.names()
         for s in registry.get(a).shapes]
# one smoke-config cell per family: (shape, dims or None, grad_accum)
SMOKE = {"qwen2.5-3b": ("train_4k", {"seq": 64, "batch": 8}, 2),
         "gcn-cora": ("molecule", None, 1),
         "dcn-v2": ("train_batch", {"batch": 256}, 1),
         "emvb-msmarco": ("serve_b32", None, 1)}
# op_stats' FLOPs a chip against hlo_stats': measured equal on three of the
# four cells and 5.1e-5 apart on dcn-v2 (its log-loss's elementwise ops
# lower to one dot on one side)
FLOPS_RTOL = 0.01
PEAK_RTOL = 0.01

REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from jax.tree_util import DictKey, GetAttrKey, SequenceKey
    from repro.configs import registry
    from repro.launch import hlo_stats, steps
    from repro.launch.mesh import make_production_mesh

    def key(k):
        if isinstance(k, DictKey):
            return k.key
        if isinstance(k, GetAttrKey):
            return k.name
        return k.idx

    def entry(e):
        if e is None:
            return []
        return list(e) if isinstance(e, tuple) else [e]

    out = {"cells": {}, "smoke": {}}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for a in registry.names():
            for s in registry.get(a).shapes:
                fn, args = steps.build_cell(a, s, mesh)
                recs = []
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        args)[0]:
                    sh = leaf.sharding
                    recs.append([[key(k) for k in path], list(leaf.shape),
                                 str(leaf.dtype),
                                 [entry(e) for e in sh.spec],
                                 list(sh.shard_shape(leaf.shape))])
                out["cells"][f"{a}|{s}|{'multi' if mp else 'single'}"] = {
                    "leaves": recs,
                    "donate": list(steps.donate_argnums(a, s))}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    for arch, (shape, dims, ga) in json.loads(sys.argv[1]).items():
        spec = registry.get(arch)
        cell = dataclasses.replace(spec.shapes[shape],
                                   dims=dims or spec.shapes[shape].dims,
                                   grad_accum=ga)
        smoke = spec.make_smoke_config
        registry._REGISTRY[arch] = dataclasses.replace(
            spec, make_config=lambda *a, smoke=smoke, **k: smoke(),
            shapes={shape: cell})
        fn, args = steps.build_cell(arch, shape, mesh)
        with mesh:
            compiled = jax.jit(fn, donate_argnums=steps.donate_argnums(
                arch, shape)).lower(*args).compile()
        st = hlo_stats.analyze(compiled.as_text())
        out["smoke"][arch] = {"flops": st["flops"],
                              "collective_by_kind": st["collective_by_kind"]}
    json.dump(out, sys.stdout)
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(SMOKE)],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def _mesh(name: str):
    return tmesh.make_production_mesh(multi_pod=(name == "multi"))


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=["|".join(c) for c in CELLS])
def test_build_cell_matches_reference(reference, arch, shape, mesh):
    """Leaves, global shapes, dtypes, specs and local shapes equal the
    reference's, so the argument bytes a chip are equal exactly; so is
    donate_argnums."""
    ref = reference["cells"][f"{arch}|{shape}|{mesh}"]
    m = _mesh(mesh)
    cell = steps.build_cell(arch, shape, m)
    mine = {}
    for path, t in steps.leaves(cell.args).items():
        sp = [list(axes_of(e)) for e in cell.specs[path]]
        mine[path] = (list(t.shape), str(t.dtype).replace("torch.", ""),
                      sp + [[]] * (t.ndim - len(sp)),
                      list(shard_shape(t.shape, cell.specs[path], m)))
    theirs = {tuple(p): (shape_, dt, spec + [[]] * (len(shape_) - len(spec)),
                         local)
              for p, shape_, dt, spec, local in ref["leaves"]}
    assert set(mine) == set(theirs)
    for path in theirs:
        assert mine[path] == theirs[path], path
    ref_bytes = sum(int(np.prod(local)) * np.dtype(
        dt if dt != "bfloat16" else "float16").itemsize
        for _, _, dt, _, local in ref["leaves"])
    assert op_stats.argument_bytes(cell) == ref_bytes
    assert list(steps.donate_argnums(arch, shape)) == ref["donate"]


@pytest.mark.parametrize("arch", registry.names())
def test_model_flops_equal_reference(arch):
    spec, rspec = registry.get(arch), rreg.get(arch)
    for shape in spec.shapes:
        assert model_flops(spec, shape) == rmf.model_flops(rspec, shape)


LMS = [a for a in registry.names() if registry.get(a).family == "lm"]


@pytest.mark.parametrize("arch", LMS)
def test_lm_param_spec_equal_reference(arch):
    """Every parameter key of the full config, with FSDP off, over "data"
    and over ("pod", "data"); and the validated spec on its shape."""
    flat = to_reference_layout(T.abstract_params(
        registry.get(arch).make_config()))
    for fsdp in (None, "data", ("pod", "data")):
        for path, t in flat.items():
            key = rules.key_str(path)
            want = rrules.lm_param_spec(key, t.ndim, fsdp)
            got = rules.lm_param_spec(key, t.ndim, fsdp)
            assert got == tuple(want), (key, got, want)
            assert rules._validate(got, t.shape) == tuple(
                rrules._validate(want, t.shape)), key


def test_roofline_and_ring_factors_equal_reference(monkeypatch):
    """With the reference's constants put in the port's module, roofline
    and the ring factors give the reference's numbers for random
    inputs."""
    for name in ("PEAK_FLOPS", "HBM_BW"):
        monkeypatch.setattr(analysis, name, getattr(ranalysis, name))
    monkeypatch.setattr(analysis, "LINK_BW", ranalysis.ICI_BW)
    rng = random.Random(0)
    for _ in range(200):
        cost = {"flops": rng.uniform(0, 1e16),
                "bytes accessed": rng.uniform(0, 1e13)}
        coll = rng.uniform(0, 1e12)
        mf = rng.choice([None, rng.uniform(1, 1e18)])
        n = rng.choice([1, 4, 256, 512])
        assert analysis.roofline(cost, coll, mf, n) == \
            ranalysis.roofline(cost, coll, mf, n)
        for kind in analysis.COLLECTIVES:
            nb, g = rng.randint(0, 1 << 40), rng.randint(1, 512)
            assert analysis.collective_link_bytes(kind, nb, g) == \
                rhlo._collective_link_bytes(kind, nb, g)
    assert analysis.roofline({}, 0.0) == ranalysis.roofline({}, 0.0)


def test_h100_constants_replace_the_v5e_ones():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (
        989e12, 3.35e12, 50e9)
    for v5e in (197e12, 819e9):
        assert v5e not in vars(analysis).values()
    assert 79 * 2**30 < analysis.HBM_CAPACITY < 80 * 10**9 * 1.07


def _smoke_cell(arch: str, mesh):
    shape, dims, ga = SMOKE[arch]
    spec = registry.get(arch)
    cell = dataclasses.replace(spec.shapes[shape],
                               dims=dims or spec.shapes[shape].dims,
                               grad_accum=ga)
    smoke = spec.make_smoke_config
    var = dataclasses.replace(spec, make_config=lambda *a, **k: smoke(),
                              shapes={shape: cell})
    return steps.build_cell(var, shape, mesh)


@pytest.mark.parametrize("arch", list(SMOKE))
def test_op_stats_flops_match_hlo_stats(reference, arch, capsys):
    """FLOPs a chip from op_stats within FLOPS_RTOL of the reference's
    hlo_stats on a 2 x 2 mesh; collective bytes by kind printed beside the
    reference's (not asserted: one is reckoned from the specs, the other
    read from what GSPMD chose)."""
    cell = _smoke_cell(arch, tmesh.Mesh(("data", "model"), (2, 2)))
    rec = op_stats.reckon(cell)
    ref = reference["smoke"][arch]
    assert rec["flops_per_chip"] == pytest.approx(ref["flops"],
                                                  rel=FLOPS_RTOL)
    with capsys.disabled():
        print(f"\n{arch} smoke 2x2: flops/chip {rec['flops_per_chip']:.6g} "
              f"(hlo_stats {ref['flops']:.6g}); collective bytes "
              f"{ {k: v * 2**30 for k, v in rec['collective_by_kind_gib'].items()} } "
              f"(hlo_stats {ref['collective_by_kind']})")


def test_extrapolated_counts_equal_a_direct_count():
    """An LM's counts made at 1 and 2 layers and 2 and 3 microbatches and
    extrapolated equal the direct count of the whole program: 3 layers,
    4 microbatches, MoE and dense. The peak, a maximum, is extrapolated
    likewise and held within PEAK_RTOL (measured 0.32 % low on granite's
    smoke config, exact on qwen's)."""
    mesh = tmesh.single_card_mesh()
    for arch, ga in (("granite-moe-1b-a400m", 4), ("qwen2.5-3b", 1)):
        spec = registry.get(arch)
        base = spec.make_smoke_config()
        cfg = dataclasses.replace(base, n_layers=3)
        cell = dataclasses.replace(spec.shapes["train_4k"],
                                   dims={"seq": 32, "batch": 4 * ga},
                                   grad_accum=ga)
        var = dataclasses.replace(spec, make_config=lambda *a, **k: cfg,
                                  shapes={"train_4k": cell})
        c = steps.build_cell(var, "train_4k", mesh)
        direct = op_stats.count(c.fn, c.args)
        got = op_stats.global_counts(c)
        for k in ("flops", "bytes", "n_ops", "output_bytes"):
            assert got[k] == direct[k], (arch, k, got[k], direct[k])
        assert got["peak_temp_bytes"] == pytest.approx(
            direct["peak_temp_bytes"], rel=PEAK_RTOL)


def test_meshes_and_shard_shape():
    single, multi = (tmesh.make_production_mesh(multi_pod=m)
                     for m in (False, True))
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert (tmesh.data_axes(single), tmesh.fsdp_axes(single)) == (
        ("data",), "data")
    assert (tmesh.data_axes(multi), tmesh.fsdp_axes(multi)) == (
        ("pod", "data"), ("pod", "data"))
    assert (tmesh.n_devices(single), tmesh.n_devices(multi),
            tmesh.n_devices(tmesh.single_card_mesh())) == (256, 512, 1)
    # GSPMD pads an uneven dimension: the local length is the ceiling
    assert shard_shape((40, 7), ("model", None), single) == (3, 7)
    assert shard_shape((49155, 3), (("data", "model"),), single) == (193, 3)
    assert shard_shape((5, 6), (), multi) == (5, 6)
    assert rules.table_sharding(single) == (("data", "model"), None)
    assert rules.batch_spec(single, ("data",)) == (("data",),)


def test_kernels_on_meta_return_shapes_and_launch_nothing():
    """On meta each wrapper returns its kernel's output shapes, reports its
    bound's bytes and launches nothing; the retrieval cell's program goes
    through the fused pair once a batch."""
    ops.reset_launches()
    mesh = tmesh.single_card_mesh()
    cell = steps.build_cell("emvb-msmarco", "serve_b32", mesh)
    got = op_stats.count(cell.fn, cell.args)
    assert got["kernels"] == {"prefilter": 1, "pqinter": 1}
    assert got["kernel_bytes"] > 0 and got["kernel_ops"] > 0
    assert all(v == 0 for v in ops.launch_counts().values())
    meta = torch.device("meta")
    cs = torch.empty((3, 32, 700), device=meta)
    codes = torch.empty((500, 10), dtype=torch.int32, device=meta)
    lens = torch.empty((500,), dtype=torch.int32, device=meta)
    assert ops.bitpack_batched(cs, 0.4).shape == (3, 700)
    words = torch.empty((3, 700), dtype=torch.int32, device=meta)
    assert ops.bitfilter_batched(words, codes, lens).shape == (3, 500)
    cs_t = torch.empty((3, 700, 32), device=meta)
    c3 = torch.empty((3, 50, 10), dtype=torch.int32, device=meta)
    l3 = torch.empty((3, 50), dtype=torch.int32, device=meta)
    lut = torch.empty((3, 32, 8, 16), device=meta)
    res = torch.empty((3, 50, 10, 8), dtype=torch.uint8, device=meta)
    assert ops.cinter_batched(cs_t, c3, l3).shape == (3, 50)
    assert ops.pqscore_batched(cs_t, lut, c3, res, l3, 0.5).shape == (3, 50)
    bitmap = torch.empty((3, 500), dtype=torch.bool, device=meta)
    sc, ids, bits = ops.prefilter_batched(cs, 0.4, codes, lens, bitmap, 64)
    assert (sc.shape, ids.shape, bits.shape) == ((3, 64), (3, 64), (3, 700))
    out = ops.pqinter_batched(cs_t, lut, c3, res, l3, 0.5, 20, 10)
    assert [tuple(x.shape) for x in out] == [(3, 10), (3, 10), (3, 20),
                                            (3, 20)]
    assert all(v == 0 for v in ops.launch_counts().values())


def test_dryrun_cli_is_resumable_and_records_failures(tmp_path, capsys,
                                                      monkeypatch):
    out = str(tmp_path / "dry.json")
    dryrun.main(["--arch", "gcn-cora", "--shape", "molecule", "--mesh",
                 "both", "--out", out])
    recs = json.load(open(out))
    assert [(r["arch"], r["shape"], r["mesh"]) for r in recs] == [
        ("gcn-cora", "molecule", "16x16"), ("gcn-cora", "molecule",
                                            "2x16x16")]
    for r in recs:
        for k in ("argument_bytes_per_chip", "output_bytes_per_chip",
                  "temp_bytes_per_chip", "peak_bytes_per_chip",
                  "collective_by_kind_gib", "n_collective_sites",
                  "reckon_s", "flops_per_chip", "bytes_per_chip",
                  "dominant", "bound_s", "useful_flops_ratio", "fits"):
            assert k in r, k
        assert "xla_cost_flops_unscaled" not in r
        assert r["fits"]
    # a second run skips both; a failing cell is recorded, the run goes on
    monkeypatch.setattr(op_stats, "reckon",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    dryrun.main(["--arch", "gcn-cora", "--mesh", "single", "--out", out])
    printed = capsys.readouterr().out
    assert "skip (recorded)" in printed and "FAILED" in printed
    recs = json.load(open(out))
    assert len(recs) == 5
    assert sum("error" in r for r in recs) == 3
