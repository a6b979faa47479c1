"""``python -m roc_tpu_torch.models``, the region-plan dump, against
``python -m roc_tpu.models``: the same arguments print the same bytes."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from roc_tpu.models import __main__ as jcli
from roc_tpu_torch.models import __main__ as cli

ROOT = Path(__file__).resolve().parents[1]

CASES = [["--depth", "0"], ["--depth", "1"], ["--depth", "2"],
         ["--model", "gcn-chain", "--layers", "602-256-256-256-41",
          "--depth", "2"],
         ["--model", "gcn", "--layers", "602-256-41"],
         ["--model", "gcn", "--layers", "64-16-16-16-8", "--depth", "0"],
         ["--model", "gat", "--layers", "602-64-41", "--heads", "4"]]


@pytest.mark.parametrize("argv", CASES, ids=[" ".join(a) for a in CASES])
def test_region_plan_is_byte_equal(argv, capsys):
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and got.endswith("\n")


def test_region_plan_cli_runs_standalone():
    """The module runs as ``python -m`` without jax or roc_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "roc_tpu_torch.models", "--model",
         "gcn-chain", "--layers", "100-256-256-47", "--depth", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == jcli.region_plan_json(
        "gcn-chain", [100, 256, 256, 47], 0) + "\n"
