"""``python -m roc_tpu_torch.fault --selftest`` (roc_tpu_torch/fault/
__main__.py), the port of roc_tpu/fault/__main__.py, on the CPU: each of
its six stages, the CLI's stage lines, and the retry backoff's
``fault_retry`` span (roc_tpu/fault/retry.py:73).  All checks exact."""

import subprocess
import sys
from pathlib import Path

import pytest

from roc_tpu_torch.fault import __main__ as cli
from roc_tpu_torch.fault import inject, retry
from roc_tpu_torch.obs import tracer

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name,stage", cli.STAGES,
                         ids=[n for n, _ in cli.STAGES])
def test_stage_passes_on_cpu(name, stage):
    try:
        stage("cpu")
    finally:
        inject.configure("")


def test_stage_names_match_roc_tpu():
    from roc_tpu.fault import __main__ as jcli
    src = Path(jcli.__file__).read_text()
    for name, _ in cli.STAGES:
        assert f'("{name}", _stage_{name})' in src


def test_selftest_prints_six_stage_lines(capsys):
    assert cli.main(["--selftest", "-device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"# fault selftest: {n} ok" for n, _ in cli.STAGES] \
        + ["fault selftest: OK"]


def test_cli_module_runs_and_usage_without_flag():
    proc = subprocess.run([sys.executable, "-m", "roc_tpu_torch.fault"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "--selftest" in proc.stdout


def test_retry_backoff_runs_under_a_fault_retry_span():
    t = tracer.get_tracer()
    was = t.enabled
    t.enabled = True
    n0 = len(t.spans())
    inject.configure("seed=1,span.io=2")
    try:
        assert retry.retrying("span.io", lambda: inject.point("span.io"),
                              base_s=0.001) is False
    finally:
        inject.configure("")
        retry.reset_retry_counts()
        t.enabled = was
    spans = [s for s in t.spans()[n0:] if s.name == "fault_retry"]
    assert [s.args for s in spans] == [{"site": "span.io", "attempt": 1},
                                       {"site": "span.io", "attempt": 2}]
    assert all(s.dur_ns > 0 for s in spans)
