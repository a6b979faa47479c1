"""The reference against the port on small inputs: the frozen copy of the
dropout streams bit for bit, and the reference's whole training step and
served logits against the port's in the precision the configuration
states (exact, and fast with its bfloat16 staging)."""

import numpy as np
import pytest
import torch

from perfbench.reference import prng
from perfbench.tests.conftest import run_tiny, tiny_cell


@pytest.mark.parametrize("seed,shape", [(0, (7, 5)), (2 ** 31 + 3, (64, 33)),
                                        (123456789, (1000,))])
def test_dropout_masks_are_the_ports_bits(seed, shape):
    from roc_tpu_torch.ops import prng as port
    for epoch, slot in ((0, 0), (5, 1)):
        k = prng.fold_in(prng.fold_in(prng.key(seed), epoch), slot)
        kp = port.fold_in(port.fold_in(port.prng_key(seed), epoch), slot)
        assert k == kp
        want = port.bernoulli(kp, 0.5, shape)
        assert torch.equal(prng.keep_mask(k, shape, 0.5, "cpu"), want)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_trainer_follows_the_reference(precision):
    """The reference stages the sums where the port does: in either
    precision the two part by float32 rounding alone."""
    cell = tiny_cell("gcn-reddit.train")
    cell.config["precision"] = precision
    res = run_tiny(cell, seconds=0.2)
    n = res["numbers"]
    assert max(n["loss1_gap"], n["loss2_gap"], n["loss3_gap"],
               n["grad_gap"]) < 1e-5, n


def test_served_logits_follow_the_reference():
    res = run_tiny(tiny_cell("gcn-reddit.serve-churn"), seconds=1.0)
    assert res["numbers"]["logit_gap"] < 1e-5, res["numbers"]
    assert res["numbers"]["rows"] > 100


def test_signed_ops_follow_the_delta_contract():
    from perfbench.serve_run import signed_ops
    rp = np.array([0, 2, 3, 4])          # node 0 <- {1, 1}, 1 <- 0, 2 <- 2
    col = np.array([1, 1, 0, 2])
    b1 = (np.array([[1, 0], [0, 2]]), np.array([[1, 0], [0, 1], [2, 1]]))
    b2 = (np.array([[1, 0], [1, 0]]), np.array([[1, 0], [1, 0], [1, 0]]))
    ops = signed_ops([b1, b2], rp, col)
    # (1, 0) is live twice: its add is a no-op, its retire takes one; (0,
    # 2) is new; (0, 1) and (2, 1): (0, 1) is live, (2, 1) never was
    assert ops[0] == [(0, 2, 1), (1, 0, -1), (0, 1, -1)]
    # one (1, 0) left: re-add no-op, then retires: one live, then dead
    assert ops[1] == [(1, 0, -1)]
