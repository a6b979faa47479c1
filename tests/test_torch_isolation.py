"""The port stands alone: roc_tpu_torch and chip_smoke.py import neither jax
nor anything of roc_tpu, and the entry points run on CUDA unless asked for
the CPU.  The import check runs in a subprocess because this test process
has jax loaded already (tests/conftest.py)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "roc_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import roc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(roc_tpu_torch.__path__,
                                                "roc_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ml_dtypes" or m.startswith("ml_dtypes.")
             or m == "roc_tpu" or m.startswith("roc_tpu."))
need = {"roc_tpu_torch.__main__", "roc_tpu_torch.fault.guard",
        "roc_tpu_torch.fault.durable", "roc_tpu_torch.fault.inject",
        "roc_tpu_torch.fault.retry", "roc_tpu_torch.graph.__main__",
        "roc_tpu_torch.graph.convert", "roc_tpu_torch.graph.lux",
        "roc_tpu_torch.graph.reorder", "roc_tpu_torch.ops.prng",
        "roc_tpu_torch.ops.kernels.dropout",
        "roc_tpu_torch.ops.kernels.aggregate_linear",
        "roc_tpu_torch.ops.kernels.build", "roc_tpu_torch.ops.kernels.gat",
        "roc_tpu_torch.ops.edge", "roc_tpu_torch.ops.softmax",
        "roc_tpu_torch.optim.adam", "roc_tpu_torch.train.driver",
        "roc_tpu_torch.models.__main__", "roc_tpu_torch.obs",
        "roc_tpu_torch.obs.channel", "roc_tpu_torch.obs.metrics",
        "roc_tpu_torch.obs.tracer", "roc_tpu_torch.obs.watchdog",
        "roc_tpu_torch.serve.__main__", "roc_tpu_torch.train.config",
        "roc_tpu_torch.train.frozen", "roc_tpu_torch.obs.roofline",
        "roc_tpu_torch.memory", "roc_tpu_torch.memory.__main__",
        "roc_tpu_torch.memory.estimator", "roc_tpu_torch.memory.planner",
        "roc_tpu_torch.memory.policy", "roc_tpu_torch.graph.partition",
        "roc_tpu_torch.stream", "roc_tpu_torch.stream.executor",
        "roc_tpu_torch.stream.host", "roc_tpu_torch.stream.ring",
        "roc_tpu_torch.stream.segments", "roc_tpu_torch.stream.spill",
        "roc_tpu_torch.serve.delta", "roc_tpu_torch.fleet",
        "roc_tpu_torch.fleet.__main__", "roc_tpu_torch.fleet.replica",
        "roc_tpu_torch.fleet.replog", "roc_tpu_torch.fleet.router",
        "roc_tpu_torch.obs.ledger", "roc_tpu_torch.obs.report",
        "roc_tpu_torch.obs.__main__", "roc_tpu_torch.fault.__main__"}
assert need <= set(names), need - set(names)
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_without_jax_or_roc_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 30 and bad.strip() == "[]"


def test_every_kernel_source_has_a_loader():
    """Each csrc/*.cu is built and loaded by one library of
    ops/kernels (and so by chip_smoke.py's build of them all)."""
    from roc_tpu_torch.ops.kernels import KERNELS, LIBRARIES
    sources = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert sources == {lib.source.name for lib in LIBRARIES}
    assert set(KERNELS) == {"aggregate_sum", "stage_plane", "aggregate_linear",
                            "aggregate_linear_bwd", "stage_cotangent",
                            "gat_score", "gat_stage",
                            "gat_forward", "gat_bwd_dst", "gat_bwd_src",
                            "xlayer_fwd", "xlayer_bwd", "dropout"}


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_roc_tpu_import_in_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "chip_ab.py"]
    assert len(files) >= 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "roc_tpu"), \
                (f, mod)


def test_entry_points_default_to_cuda():
    """device=None means CUDA: without a GPU the engine raises instead of
    running on the CPU."""
    from roc_tpu_torch.graph import datasets
    from roc_tpu_torch.models import build_model
    from roc_tpu_torch.serve import ServeEngine
    from roc_tpu_torch.train.config import Config
    from roc_tpu_torch.train.frozen import load_frozen
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately runs there")
    cfg = Config(dataset="roc-audit", layers=[8, 16, 4])
    ds = datasets.get(cfg.dataset)
    model = build_model("gcn", cfg.layers)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, ds, model, start_queue=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_frozen(cfg, ds, model)


@pytest.mark.parametrize("module,argv", [
    ("roc_tpu_torch.fault.__main__", ["--selftest"]),
    ("roc_tpu_torch.fleet.__main__", ["--selftest"]),
    ("roc_tpu_torch.obs.__main__", ["calibration", "--selftest"])])
def test_selftest_clis_default_to_cuda(module, argv):
    """The selftests run on the card unless asked for the CPU: without a
    GPU and without -device cpu they raise before any stage's work."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the selftests legitimately run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(module).main(argv)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_port(tmp_path, alone):
    """Without a GPU (or without the package beside it) chip_smoke.py exits
    non-zero and prints no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
