"""The byte and operation counts, against a count by hand on an index of
four docs, and against the kernel's worst case on the Eq. 6 term."""
import pytest
import torch

from harness import planted, yardstick

CONFIG = {"list_cap": 8, "engine": {"n_q": 2, "nprobe": 1, "th": 0.5,
                                    "th_r": 0.5, "n_filter": 2, "n_docs": 1,
                                    "k": 1}}


def _tiny():
    """Centroids e0..e3; doc 0 [c0, c2], doc 1 [c1, c1, c3], doc 2
    [c2, c3], doc 3 [c0, c1, c2]; pad code 4."""
    codes = torch.tensor([[0, 2, 4], [1, 1, 3], [2, 3, 4], [0, 1, 2]],
                         dtype=torch.int32)
    data = planted.PlantedData(
        centroids=torch.eye(4), codes=codes,
        doc_lens=torch.tensor([2, 3, 2, 3], dtype=torch.int32),
        res_codes=torch.zeros((4, 3, 2), dtype=torch.uint8),
        pq_codebooks=torch.zeros((2, 2, 2)))
    q = torch.eye(4)[None, :2]            # terms e0 and e1
    return data, q


@pytest.mark.parametrize("th_r,pq_bytes,pq_ops", [
    # each term keeps one token of the winner (doc 3): 2 residuals, 2 pairs
    (0.5, 20 + 8 + 24 + 32 + 2 * 2 + 2 + 8 + 8, 5 * 2 + 2 * 3),
    # no token beats th_r: both terms fall back to all 3 tokens
    (1.5, 20 + 8 + 24 + 32 + 3 * 2 + 2 + 8 + 8, 5 * 2 + 6 * 3),
])
def test_counts_equal_a_hand_count(th_r, pq_bytes, pq_ops):
    from references.emvb import Reference
    data, q = _tiny()
    cfg = {**CONFIG, "engine": {**CONFIG["engine"], "th_r": th_r}}
    out = Reference(data, None, cfg).run(q, counts=True)
    assert out["ids"].tolist() == [[3]]
    c = out["counts"]
    # candidates: lists c0 {0, 3} and c1 {1, 3}: docs 0, 1, 3 with 8 tokens
    pre = yardstick.prefilter_bound(c["prefilter"])
    assert (pre["bytes"], pre["ops"]) == (32 + 4 + 2 + 12 + 32 + 16 + 16,
                                          8 + 8)
    # survivors docs 3 and 0 (F 2 and 1): 5 tokens on rows c0, c1, c2
    late = yardstick.pqinter_bound(c["pqinter"])
    assert (late["bytes"], late["ops"]) == (pq_bytes, pq_ops)


def test_bound_takes_the_larger_term():
    b = yardstick.bound(int(3.35e9), int(6.7e9))
    assert b["bound_ms"] == pytest.approx(1.0)
    assert b["bound_by"] == "bytes"
    b = yardstick.bound(1, int(6.7e10))
    assert b["bound_ms"] == pytest.approx(1.0)
    assert b["bound_by"] == "operations"
