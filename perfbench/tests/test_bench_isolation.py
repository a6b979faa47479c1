"""Nothing the benchmark runs loads JAX or the JAX package: every module
under perfbench/, and a CPU dry run of each kind of cell, in a fresh
process, compared by whole top-level names."""

import subprocess
import sys

from perfbench import harness, spec

PROBE = r"""
import importlib, pkgutil, sys, time, torch
sys.path.insert(0, {root!r})
import perfbench
for m in pkgutil.walk_packages(perfbench.__path__, "perfbench."):
    if ".tests" in m.name or m.name.endswith((".run", ".__main__",
                                                ".sweep", ".control")):
        continue
    importlib.import_module(m.name)
from perfbench import harness
from perfbench.tests.conftest import tiny_cell, run_tiny
for name in ("gcn-reddit.train", "gcn-reddit.serve-churn"):
    run_tiny(tiny_cell(name), seconds=0.3)
print("FOUND", harness.forbidden_modules())
"""


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["roc_tpu_torch", "roc_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["roc_tpu.ops", "jax._src", "flax"]) == ["flax", "jax", "roc_tpu"]


def test_a_dry_run_loads_neither_jax_nor_roc_tpu():
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(spec.ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"
