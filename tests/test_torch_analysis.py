"""roclint for the port (roc_tpu_torch/analysis/lint.py): each ported rule
fires on a positive fixture, stays silent on a clean one and on a waived
one; the port's tree has zero findings, as roc_tpu's has under its own
lint (tests/test_analysis.py); every waiver in the port carries a reason.
The fixtures follow tests/test_analysis.py's, on PyTorch spellings."""

import os
import subprocess
import sys

import pytest

from roc_tpu.analysis import lint as jlint
from roc_tpu_torch.analysis import lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "roc_tpu_torch"

# rule -> (path the fixture is linted as, positive sources)
_POSITIVE = {
    "host-sync": ("<host-sync>", [
        "import time\ndef bench(fn, x):\n    t0 = time.perf_counter()\n"
        "    fn(x).item()\n    return time.perf_counter() - t0\n",
        "import time, torch\ndef bench(fn, x):\n"
        "    t0 = time.perf_counter()\n    fn(x)\n"
        "    torch.cuda.synchronize()\n"
        "    return time.perf_counter() - t0\n",
        "import time\ndef bench(fn, x):\n    t0 = time.perf_counter()\n"
        "    y = fn(x).cpu()\n    return time.perf_counter() - t0, y\n",
    ]),
    "unkeyed-rand": ("<r>", ["import numpy as np\ni = np.random.randint(0, 9)\n",
                             "import numpy as np\nnp.random.seed(0)\n"]),
    "mutable-default": ("<m>", ["def f(x, acc=[]):\n    acc.append(x)\n"
                                "    return acc\n",
                                "def f(x, seen=set()):\n    return seen\n"]),
    "closure-capture": ("<c>", ["fns = []\nfor i in range(3):\n"
                                "    fns.append(lambda: i + 1)\n"]),
    "remat": (f"{PKG}/parallel/x.py", [
        "from torch.utils.checkpoint import checkpoint\n"
        "y = checkpoint(f, x, use_reentrant=False)\n",
        "import torch\ny = torch.utils.checkpoint.checkpoint(f, x)\n",
        "import torch.utils.checkpoint as cp\n"
        "y = cp.checkpoint_sequential(fs, 2, x)\n",
    ]),
    "raw-timing": (f"{PKG}/serve/x.py", [
        "import time\ndef f():\n    t0 = time.perf_counter()\n"
        "    work()\n    return time.perf_counter() - t0\n",
        "import time\nt = time.perf_counter_ns()\nwork()\n"
        "dt = time.perf_counter_ns() - t\n",
    ]),
    "unledgered-prediction": ("<p>", [
        "row = {'predicted_step_s': 0.1, 'nodes': 4}\n",
        "def f(reg, t):\n    reg.emit('epoch', measured_step_s=t)\n",
        "def f(buf, t):\n    buf.record_event('probe', predicted_time_s=t)\n",
    ]),
    "silent-swallow": ("<s>", [
        "try:\n    sync()\nexcept OSError:\n    pass\n",
        "for p in paths:\n    try:\n        load(p)\n"
        "    except Exception:\n        continue\n",
    ]),
    "unpinned-host-buffer": (f"{PKG}/stream/executor.py", [
        "import numpy as np\nbuf = np.zeros((4, 8), np.float32)\n",
        "import torch\nbuf = torch.empty(4, 8)\n",
        "import torch\nbuf = torch.zeros((4, 8), dtype=torch.float32)\n",
    ]),
    "hand-rolled-geometry": (f"{PKG}/serve/x.py", [
        "from roc_tpu_torch.ops.kernels.gat import FwdGeometry\n"
        "g = FwdGeometry(1, 16, 3, False, 64)\n",
        "from roc_tpu_torch.ops import aggregate\n"
        "t = aggregate.LaunchTable('fast', (8, 2), (8, 2))\n",
    ]),
}

# the serving path's sync rule fires on a serve/ or fleet/ path only
_SERVE_POSITIVE = [
    "def f(t):\n    return t.item()\n",
    "def f(t):\n    return t.cpu().numpy()\n",
    "import numpy as np\ndef f(ids):\n    return np.asarray(ids)\n",
    "import torch\ndef f():\n    torch.cuda.synchronize()\n",
]

_CLEAN = [
    # syncs outside a timing window and off the serving path are fine
    ("<x>", "def log(x):\n    return x.item(), x.cpu()\n"),
    ("<x>", "import numpy as np\nrng = np.random.default_rng(0)\n"
            "i = rng.integers(0, 9)\n"),
    ("<x>", "def f(x, acc=None):\n    return (acc or []) + [x]\n"),
    ("<x>", "fns = []\nfor i in range(3):\n    fns.append(lambda i=i: i + 1)\n"),
    # a long timing window (a whole epoch loop): the syncs are the workload
    ("<x>", "import time\ndef run(fn, x):\n    t0 = time.perf_counter()\n"
            + "    x = fn(x)\n" * 14
            + "    x.item()\n    return time.perf_counter() - t0\n"),
    ("<x>", "row = {'prediction': 0.1, 'measure': 2}\n"
            "def f(reg, t):\n    reg.emit('epoch', step_s=t)\n"),
    ("<x>", "try:\n    sync()\nexcept OSError as e:\n    log(e)\n"),
    # the sanctioned sites
    (f"{PKG}/memory/policy.py",
     "from torch.utils.checkpoint import checkpoint\ny = checkpoint(f, x)\n"),
    (f"{PKG}/obs/tracer.py", "import time\nt0 = time.perf_counter()\n"
                             "dt = time.perf_counter() - t0\n"),
    (f"{PKG}/obs/ledger.py", "row = {'predicted_step_s': 0.1}\n"),
    (f"{PKG}/stream/host.py", "import numpy as np\nb = np.empty(4)\n"),
    (f"{PKG}/stream/executor.py",
     "import torch\nb = torch.empty(4, pin_memory=True)\n"
     "d = torch.zeros(4, device=dev)\n"),
    (f"{PKG}/ops/kernels/gat.py", "g = FwdGeometry(1, 16, 3, False, 64)\n"),
    (f"{PKG}/tune/store.py", "t = LaunchTable('fast', (8, 2))\n"),
    (f"tests{os.sep}test_x.py", "try:\n    f()\nexcept OSError:\n    pass\n"),
    ("test_x.py", "g = FwdGeometry(1, 16, 3, False, 64)\n"),
    # the same sync off the serving path
    (f"{PKG}/train/driver.py", "def f(t):\n    return t.item()\n"),
    # a method that happens to be called checkpoint is not recomputation
    (f"{PKG}/parallel/x.py", "def f(mgr):\n    mgr.checkpoint()\n"),
]


@pytest.mark.parametrize("rule", sorted(_POSITIVE))
def test_rule_fires(rule):
    path, sources = _POSITIVE[rule]
    for src in sources:
        fs = lint.lint_source(src, path)
        assert any(f.rule == rule for f in fs), (rule, src, fs)


@pytest.mark.parametrize("where", ["serve", "fleet"])
def test_serving_path_sync_fires(where):
    for src in _SERVE_POSITIVE:
        fs = lint.lint_source(src, f"{PKG}/{where}/engine.py")
        assert [f.rule for f in fs] == ["host-sync"], (src, fs)


@pytest.mark.parametrize("case", range(len(_CLEAN)))
def test_clean_fixture_is_silent(case):
    path, src = _CLEAN[case]
    assert lint.lint_source(src, path) == [], src


@pytest.mark.parametrize("rule", sorted(_POSITIVE))
def test_waiver_silences_exactly_its_rule(rule):
    """A waiver on the preceding line silences the rule; a waiver of
    another rule silences nothing."""
    path, sources = _POSITIVE[rule]
    for src in sources:
        lines = src.splitlines()
        hits = {f.line for f in lint.lint_source(src, path)
                if f.rule == rule}
        waived, wrong = list(lines), list(lines)
        for ln in sorted(hits, reverse=True):
            ind = " " * (len(lines[ln - 1]) - len(lines[ln - 1].lstrip()))
            waived.insert(ln - 1, f"{ind}# roclint: allow({rule}) reason")
            wrong.insert(ln - 1, f"{ind}# roclint: allow(other-rule) reason")
        assert not [f for f in lint.lint_source("\n".join(waived) + "\n",
                                                path) if f.rule == rule]
        assert [f for f in lint.lint_source("\n".join(wrong) + "\n", path)
                if f.rule == rule]


def test_rules_agree_with_roc_tpu_where_they_are_the_same():
    """The rules copied as they are flag what roc_tpu's lint flags."""
    for rule in ("unkeyed-rand", "mutable-default", "closure-capture",
                 "unledgered-prediction", "silent-swallow"):
        path, sources = _POSITIVE[rule]
        for src in sources:
            assert {(f.line, f.rule) for f in lint.lint_source(src, path)} \
                == {(f.line, f.rule) for f in jlint.lint_source(src, path)}


def test_port_tree_has_zero_findings():
    os.chdir(ROOT)
    assert lint.lint_paths([PKG]) == []


def test_every_waiver_has_a_reason(tmp_path):
    os.chdir(ROOT)
    rows = lint.list_waivers([PKG])
    assert len(rows) >= 40, "waiver inventory came back short: walker broke"
    assert [r for r in rows if not r[3]] == []
    # a waiver without prose is caught, a mention in prose is not a waiver
    f = tmp_path / "w.py"
    f.write_text("x = 1  # roclint: allow(host-sync)\n"
                 "# see ``# roclint: allow(remat)`` in the docs\n")
    assert lint.list_waivers([str(f)]) == [(str(f), 1, "host-sync", "")]


@pytest.mark.parametrize("argv,rc", [([], 0), (["--list-waivers"], 0)])
def test_cli_on_the_tree(argv, rc):
    proc = subprocess.run([sys.executable, "-m", "roc_tpu_torch.analysis.lint",
                           *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stderr or "0 without a reason" \
        in proc.stderr


def test_cli_exits_1_on_a_finding(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("def f(x, acc=[]):\n    return acc\n")
    proc = subprocess.run([sys.executable, "-m", "roc_tpu_torch.analysis.lint",
                           str(f)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1 and "mutable-default" in proc.stdout
