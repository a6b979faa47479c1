"""The control: the program with its own ``-bf16`` path on (bfloat16
features and tensor-core GEMMs), the step below the float32 GEMMs the
configurations state.  On the card, at the cells' own size, it reads far
above each limit (``perfbench/control.py --mode bf16``; PERF.md gives the
readings the limits were set from).  A limit is set for its cell's size
and does not carry to a graph of 300 nodes, so here the control has to
read at least three times what the program reads on the same inputs, in
one of the cell's compared numbers."""

import time

import pytest
import torch

from perfbench import check, harness, serve_run, spec, train_run
from perfbench.tests.conftest import tiny_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2 ** 31 + 11


def _numbers(cell, control: bool) -> dict:
    if cell.traffic["kind"] == "train":
        return train_run.readings(cell.config, cell.traffic, SEED,
                                  torch.device("cpu"),
                                  "bf16" if control else "program")
    ctx = harness.Context(cell, SEED, 1.0, False, time.perf_counter(),
                          torch.device("cpu"))
    ctx.use_bf16 = control
    return serve_run.run(ctx)["numbers"]


@pytest.mark.parametrize("name", CELLS)
def test_the_bf16_path_reads_three_times_the_program(name):
    cell = tiny_cell(name)
    limits = check.limits_for(name)
    prog, ctl = _numbers(cell, False), _numbers(cell, True)
    ratios = {k: ctl[k] / max(prog[k], 1e-12) for k in limits}
    assert max(ratios.values()) >= 3.0, (prog, ctl)
