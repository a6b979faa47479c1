"""The rest of a run, past the look for a chip, with the timed path
broken underneath: ``correct`` has to come out false, once for each fault
that each kind of cell can have.  (One chip: no exchange between chips to
leave out.)"""

import torch

from perfbench import harness
from perfbench.tests.conftest import run_tiny, tiny_cell


def _correct(cell) -> bool:
    res = run_tiny(cell, seconds=1.0)
    return harness.result_line(cell, res, False, {})["correct"]


def _unchanged(optimizer, params, grads, opt_state, alpha, loss=None):
    """A step that returns its state unchanged."""
    return params, opt_state, torch.zeros((), dtype=torch.bool), \
        torch.zeros(())


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from roc_tpu_torch.train import driver
    monkeypatch.setattr(driver, "guarded_update", _unchanged)
    assert not _correct(tiny_cell("gcn-reddit.train"))


def test_half_of_the_batch_left_out(monkeypatch):
    from roc_tpu_torch import ops
    real = ops.masked_softmax_cross_entropy

    def half(logits, labels, mask):
        """The loss over every other train row, doubled: the mean over
        the rest."""
        keep = torch.arange(mask.numel(), device=mask.device) % 2 == 0
        return 2.0 * real(logits, labels, torch.where(keep, mask, 3))
    monkeypatch.setattr(ops, "masked_softmax_cross_entropy", half)
    assert not _correct(tiny_cell("gcn-reddit.train"))


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from roc_tpu_torch.serve.engine import ServeEngine
    real = ServeEngine._serve_rows

    def altered(self, ids):
        out = real(self, ids).copy()
        out[0, 0] += 1.0
        return out
    monkeypatch.setattr(ServeEngine, "_serve_rows", altered)
    assert not _correct(tiny_cell("gcn-reddit.serve-churn"))


def test_a_delta_acknowledged_but_never_patched(monkeypatch):
    from roc_tpu_torch.serve.delta import DeltaManager
    monkeypatch.setattr(DeltaManager, "_patch", lambda self, touched: None)
    assert not _correct(tiny_cell("gcn-reddit.serve-churn"))
