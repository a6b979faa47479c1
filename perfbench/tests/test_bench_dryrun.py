"""A CPU dry run of each cell of BENCHMARK.json at a tiny size, through
the port's plain paths: the run reaches its end, the result line has every
end-to-end metric of the cell and every compared number beside its
limit."""

import json
import math

import pytest

from perfbench import harness, spec
from perfbench.tests.conftest import run_tiny, tiny_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_dry_run(name):
    cell = tiny_cell(name)
    res = run_tiny(cell, seconds=1.0)
    assert res["attempted"] > 0 and res["failed"] == 0
    line = harness.result_line(cell, res, False, {"platform": "cpu"})
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(math.isfinite(m["value"]) and m["value"] >= 0
               for m in line["metrics"].values())
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        # fast precision on a 300-node graph: far under any fault's reading
        assert 0 <= c["value"] < 0.05
    json.dumps(line, allow_nan=False)
