"""The plain reference against the program, and the check's control.

On the CPU the program runs its kernels' plain versions
(``device="cpu"``); at the small size it equals the reference to the bit,
ids and scores, in every cell's budgets. The control (the reference with
TF32 products) has to fail each cell's limits; on the card it is read at
the cell's own size by ``tools/readings.py`` and here at the small one.
"""
import pytest
import torch

from conftest import CELLS, small_cell
from harness import check, control, planted, traffic


def _served_and_reference(cell, seed, device, n_batches=2):
    cfg, mix = cell.config, cell.traffic
    widths = {k: cfg[k] for k in ("n_docs", "cap", "min_len", "d",
                                  "n_centroids", "m", "nbits")}
    data = planted.make_data(seed, device=device, **widths)
    tf = traffic.make(mix, data, seed, n_batches / mix["pool_batches_per_s"],
                      cfg["engine"]["n_q"])
    system = cell.system.System(data, tf.plane, cfg, device)
    ref = cell.reference.Reference(data, tf.plane, cfg)
    out = []
    for i in range(n_batches):
        pred = None if tf.filters is None else tf.filters[i]
        sc, ids = (x.cpu() for x in system(tf.batches[i], pred))
        r = ref.run(tf.batches[i], pred, score_ids=ids)
        out.append((sc, ids, r))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_program_on_the_cpu(name):
    for sc, ids, r in _served_and_reference(small_cell(name), 5,
                                            torch.device("cpu")):
        assert torch.equal(ids.long(), r["ids"])
        assert torch.equal(sc, r["scores"])
        fin = torch.isfinite(sc)
        assert torch.equal(sc[fin], r["eq6_of"][fin].float())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = small_cell(name)
    nums = control.control_numbers(cell, 9, torch.device("cpu"), 4)
    ok, checks = check.verdict(nums, cell.limits)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels run only there")
    cell = small_cell(name)
    dev = torch.device("cuda")
    served = _served_and_reference(cell, 6, dev)
    fails = None
    nums = check.numbers([(sc, ids) for sc, ids, _ in served],
                         [r for _, _, r in served], fails)
    assert check.verdict({k: v for k, v in nums.items()
                          if k != "filter_fail"}, cell.limits)[0], nums
    nums = control.control_numbers(cell, 6, dev, 4)
    assert not check.verdict(nums, cell.limits)[0], nums
