"""Each cell of BENCHMARK.json end to end on the card, as the benchmark's
command runs it, in a short window: the result line has the contract's
keys and comes out correct.  Skips where torch finds no card."""

import json
import subprocess
import sys

import pytest

from perfbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, cuda_device):
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", name,
         "--seed", str(2 ** 31 + 17), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["device"]["platform"] == "gpu"
    assert line["correct"], line["checks"]
