"""Filtered retrieval on the port: the filter vocabulary
(``repro_torch.core.bitvector``: ``PredicateSet``, ``FilterExpr``,
``compile_filter``, ``apply_filter_plan``) against the reference's, and the
reference's filter matrix (tests/test_filtering.py) on the port's modes —
reference math, the unfused kernel lane and the fused one, each in
score_all and compact candidate mode, at B = 1 and B = 3, with and without
a padded term mask: under lossless budgets filtered retrieval equals
retrieve-then-post-filter, ids and float32 score bits.

The index is built with ``repro`` (three predicates, one of them rare),
saved with ``repro.core.store.save_index`` and loaded into the port.
tests/test_torch_filter_engine.py holds the port against the reference
under lossy budgets.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvector as rbv
from repro.core import engine as reng
from repro.core import store as rstore
from repro.core.index import build_index
from repro_torch.core import bitvector as tbv
from repro_torch.core import engine as teng
from repro_torch.core import store as tstore

torch.set_num_threads(1)

N_DOCS, CAP, D, N_Q = 96, 12, 16, 8
NAMES = ("lang_en", "recent", "rare")


def filter_corpus():
    """Docs with ragged lengths, three predicates (``rare`` holds for a few
    docs) and five queries; numpy from a seed."""
    rng = np.random.default_rng(0)
    embs = rng.normal(size=(N_DOCS, CAP, D)).astype(np.float32)
    lens = rng.integers(4, CAP + 1, size=N_DOCS).astype(np.int32)
    embs[np.arange(CAP)[None, :] >= lens[:, None]] = 0.0
    preds = {"lang_en": rng.random(N_DOCS) < 0.7,
             "recent": rng.random(N_DOCS) < 0.5,
             "rare": rng.random(N_DOCS) < 0.05}
    queries = rng.normal(size=(5, N_Q, D)).astype(np.float32)
    return embs, lens, preds, queries


def build_filter_index(path):
    """(reference index, meta, port index, queries, predicates)."""
    embs, lens, preds, queries = filter_corpus()
    ref, meta = build_index(jax.random.PRNGKey(0), embs, lens,
                            n_centroids=32, predicates=preds)
    port, _ = tstore.load_index(rstore.save_index(str(path), ref, meta),
                                device="cpu")
    return ref, meta, port, queries, preds


@pytest.fixture(scope="module")
def findex(tmp_path_factory):
    return build_filter_index(tmp_path_factory.mktemp("filter") / "idx")


# lossless budgets: every phase keeps the whole corpus
BASE = dict(n_q=N_Q, nprobe=4, th=0.2, th_r=0.3, n_filter=N_DOCS,
            n_docs=N_DOCS, k=8, cand_cap=N_DOCS)
UNFUSED = dict(use_kernels=True, fused_prefilter=False,
               fused_late_interaction=False)
MODES = {
    "ref-score_all": {},
    "ref-compact": dict(candidate_mode="compact"),
    "unfused-score_all": UNFUSED,
    "unfused-compact": dict(UNFUSED, candidate_mode="compact"),
    "fused-score_all": dict(use_kernels=True),
    "fused-compact": dict(use_kernels=True, candidate_mode="compact"),
}
EXPR_R = rbv.Pred("recent") & ~rbv.Pred("lang_en")
EXPR_T = tbv.Pred("recent") & ~tbv.Pred("lang_en")


# ---------------------------------------------------------------------------
# The vocabulary
# ---------------------------------------------------------------------------

def _both(build):
    """The same expression built from each package's classes."""
    return build(rbv), build(tbv)


EXPRESSIONS = {
    "leaf": lambda m: m.Pred("a"),
    "not": lambda m: ~m.Pred("b"),
    "demorgan_and": lambda m: ~(m.Pred("a") & m.Pred("b")),
    "demorgan_or": lambda m: ~(m.Pred("a") | m.Pred("c")),
    "ors_of_nots": lambda m: ~m.Pred("a") | ~m.Pred("b"),
    "contradiction": lambda m: m.Pred("a") & ~m.Pred("a"),
    "half_contradiction": lambda m: (m.Pred("a") & ~m.Pred("a"))
    | m.Pred("c"),
    "duplicate_clause": lambda m: (m.Pred("a") & m.Pred("b"))
    | (m.Pred("b") & m.Pred("a")),
    "duplicate_leaf": lambda m: m.Pred("c") | m.Pred("c"),
    "forbidden_bits": lambda m: (m.Pred("a") | m.Pred("top"))
    & ~(m.Pred("b") | m.Pred("c")),
    "double_negation": lambda m: ~~(m.Pred("a") & ~m.Pred("top")),
    "distribute": lambda m: (m.Pred("a") | m.Pred("b"))
    & (m.Pred("c") | ~m.Pred("top")),
}
VOCAB = ("a", "b", "c", *(f"p{i}" for i in range(28)), "top")  # bit 31


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_compile_filter_matches_reference(name):
    ref_expr, port_expr = _both(EXPRESSIONS[name])
    want = rbv.compile_filter(ref_expr, VOCAB)
    got = tbv.compile_filter(port_expr, VOCAB)
    assert got.names == want.names == VOCAB
    assert got.clauses == want.clauses
    assert hash(port_expr) == hash(_both(EXPRESSIONS[name])[1])
    rng = np.random.default_rng(len(name))
    words = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    words[:8] = [0, 1, 2, 3, 1 << 31, 0xFFFFFFFF, 0x80000001, 7]
    np.testing.assert_array_equal(
        tbv.apply_filter_plan(got, torch.from_numpy(words)).numpy(),
        np.asarray(rbv.apply_filter_plan(want, jnp.asarray(words))))


@pytest.mark.parametrize("clauses", [(), ((0, 0),), ((5, 0), (0, 5)),
                                     ((1 << 31, 2), (6, 1 << 31))])
def test_raw_plans_match_reference(clauses):
    """An empty plan passes nothing, (0, 0) everything; raw clause tuples
    (what the kernels take) evaluate as the reference's."""
    words = np.random.default_rng(1).integers(
        0, 1 << 32, size=2000, dtype=np.uint64).astype(np.uint32)
    got = tbv.apply_filter_plan(clauses, torch.from_numpy(words)).numpy()
    want = np.asarray(rbv.apply_filter_plan(clauses, jnp.asarray(words)))
    np.testing.assert_array_equal(got, want)
    if clauses in ((), ((0, 0),)):
        assert got.all() == bool(clauses) and got.any() == bool(clauses)


def _raises_same(call):
    """Run ``call(module)`` for both packages; both raise the same error."""
    with pytest.raises((ValueError, TypeError)) as want:
        call(rbv)
    with pytest.raises(type(want.value)) as got:
        call(tbv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", [
    lambda m: m.compile_filter(m.Pred("nope"), ("a", "b")),
    lambda m: m.compile_filter(m.Pred("a") & m.Pred("zz"), ("a",)),
    lambda m: m.compile_filter(m.Pred("a"), ()),
    lambda m: m.compile_filter(m.Pred("p0"),
                               tuple(f"p{i}" for i in range(33))),
    lambda m: m.compile_filter(m.Pred("a"), ("a", "a")),
    lambda m: m.compile_filter("a", ("a",)),
    lambda m: m.PredicateSet.pack({}),
    lambda m: m.PredicateSet.pack({f"p{i}": np.ones(4, bool)
                                   for i in range(33)}),
    lambda m: m.PredicateSet.pack({"p": np.ones((4, 2), bool)}),
    lambda m: m.PredicateSet.pack({"p": np.ones(4, bool),
                                   "q": np.ones(5, bool)}),
    lambda m: m.PredicateSet.pack({"p": np.ones(4, bool)}).mask("nope"),
], ids=["unknown", "unknown_nested", "no_plane", "over_32", "duplicate",
        "not_an_expr", "empty_pack", "pack_over_32", "pack_2d",
        "pack_ragged", "mask_unknown"])
def test_errors_match_reference(call):
    _raises_same(call)


def test_predicate_set_matches_reference():
    _, _, preds, _ = filter_corpus()
    preds = dict(preds, **{f"p{i}": np.arange(N_DOCS) % (i + 2) == 0
                           for i in range(29)})
    assert len(preds) == 32                 # bit 31 in use
    want = rbv.PredicateSet.pack(preds)
    got = tbv.PredicateSet.pack(preds)
    assert got.names == want.names
    assert got.words.dtype == torch.uint32
    np.testing.assert_array_equal(got.words.numpy(), np.asarray(want.words))
    for name in preds:
        np.testing.assert_array_equal(got.mask(name).numpy(),
                                      np.asarray(want.mask(name)))


def test_plan_on_the_loaded_plane(findex):
    ref, meta, port, _, preds = findex
    assert meta.pred_names == NAMES
    plan = tbv.compile_filter(EXPR_T, meta.pred_names)
    got = tbv.apply_filter_plan(plan, port.pred_words).numpy()
    np.testing.assert_array_equal(got, preds["recent"] & ~preds["lang_en"])
    np.testing.assert_array_equal(got, np.asarray(rbv.apply_filter_plan(
        rbv.compile_filter(EXPR_R, meta.pred_names), ref.pred_words)))


def test_engine_config_rejects_uncompiled_expr():
    with pytest.raises(ValueError) as want:
        reng.EngineConfig(doc_filter=rbv.Pred("a"))
    with pytest.raises(ValueError, match="compile your FilterExpr") as got:
        teng.EngineConfig(doc_filter=tbv.Pred("a"))
    assert str(got.value) == str(want.value)
    plan = tbv.compile_filter(tbv.Pred("a"), ("a",))
    assert teng.EngineConfig(doc_filter=plan).doc_filter is plan


# ---------------------------------------------------------------------------
# The matrix: filtered == retrieve-then-post-filter, bit-exact
# ---------------------------------------------------------------------------

def _post_filter(res, passing, k):
    """The oracle: an unfiltered full ranking cut to its passing docs."""
    ids, scores = res.doc_ids.numpy(), res.scores.numpy()
    keep = passing[ids]
    return (np.stack([s[m][:k] for s, m in zip(scores, keep)]),
            np.stack([i[m][:k] for i, m in zip(ids, keep)]))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("padded", [False, True])
def test_filtered_equals_postfilter(findex, mode, nb, padded):
    _, meta, port, queries, _ = findex
    q = torch.from_numpy(np.array(queries[:nb]))
    qm = None
    if padded:
        qm = torch.ones(nb, N_Q, dtype=torch.bool)
        qm[:, 5:] = False
        q[~qm] = 0.0
    cfg = teng.EngineConfig(**BASE, **MODES[mode])
    plan = tbv.compile_filter(EXPR_T, meta.pred_names)
    passing = tbv.apply_filter_plan(plan, port.pred_words).numpy()
    assert cfg.k <= passing.sum()
    full = teng.retrieve(port, q, dataclasses.replace(cfg, k=N_DOCS), qm,
                         device="cpu")
    want_s, want_i = _post_filter(full, passing, cfg.k)
    got = teng.retrieve(port, q, cfg, qm, doc_filter=plan, device="cpu")
    same = teng.retrieve(port, q, dataclasses.replace(cfg, doc_filter=plan),
                         qm, device="cpu")
    assert torch.equal(got.doc_ids, same.doc_ids)
    np.testing.assert_array_equal(got.doc_ids.numpy(), want_i)
    np.testing.assert_array_equal(got.scores.numpy().view(np.uint32),
                                  want_s.view(np.uint32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_filter_passing_nothing(findex, mode):
    """A contradiction passes no doc: every lane returns k -inf entries."""
    _, meta, port, queries, _ = findex
    plan = tbv.compile_filter(tbv.Pred("rare") & ~tbv.Pred("rare"),
                              meta.pred_names)
    assert plan.clauses == ()
    got = teng.retrieve(port, torch.from_numpy(queries[:2]),
                        teng.EngineConfig(**BASE, **MODES[mode]),
                        doc_filter=plan, device="cpu")
    assert torch.isneginf(got.scores).all()


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("n_docs,cand_cap", [(97, 1), (97, 40), (97, 97),
                                             (1030, 300), (1030, 1030)])
def test_compact_candidates_match_reference(density, n_docs, cand_cap):
    """The candidate buffer: ids and validity as the reference's
    ``lax.top_k`` over the bool bitmap gives them, candidates ascending and
    then non-candidates ascending; a row with no candidate and one that is
    all candidates included, and a corpus over several 256-doc runs of the
    port's search."""
    rng = np.random.default_rng(int(density * 100) + cand_cap)
    bitmap = rng.random((4, n_docs)) < density
    bitmap[0] = False
    bitmap[1] = True
    kw = dict(n_filter=1, n_docs=1, k=1, candidate_mode="compact",
              cand_cap=cand_cap)
    want = jax.vmap(lambda b: reng._compact_candidates(
        b, reng.EngineConfig(**kw)))(jnp.asarray(bitmap))
    got = teng._compact_candidates(torch.from_numpy(bitmap),
                                   teng.EngineConfig(**kw))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
