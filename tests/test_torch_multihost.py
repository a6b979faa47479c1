"""``-multihost`` (roc_tpu_torch.parallel.collectives and the SPMD trainer
across processes) on the CPU over gloo.

The two-process runs spawn the CLI itself (``python -m roc_tpu_torch
-multihost -device cpu ...``) with torchrun's variables in each process's
environment, on a free port, under a hard deadline (one retry on a fresh
port after a bind failure or a hang).  Each is held against roc_tpu's
single-process SpmdTrainer at the same P (``-aggr-backend xla``, the 8 host
devices of tests/conftest.py): a sharded result does not depend on the
process layout.  What the runs leave behind is compared: each rank's
``-obs`` record (``obs_dir/rank{r}/metrics.jsonl``: every epoch's loss at
full precision), the accuracy counts of each rank's printed metric lines,
and rank 0's checkpoint.  The resumed ring leg is held against the port's
own single-process trainer restored from the same checkpoint: roc_tpu's
SpmdTrainer can neither write nor restore a sharded checkpoint (its
``_resume_extra`` and ``restore`` choke on the partition's 2-D bounds),
and its Adam moments are P times the port's (its gradients come out P
times the summed gradient), so a port checkpoint resumed there trains on
another state.

Tolerances:
  the collectives in a world of one, and their gradients    exact
  torch_allgather of int64 past 2^31                         exact
  two-process losses vs roc_tpu's trainer                    1e-5 relative
  their accuracy counts                                      equal
  the resumed ring leg vs the port's single process          1e-5 relative,
                                                             counts equal
  the two ranks' losses and printed lines                    equal
  rank 0's checkpoint params vs the port's single process    1e-5 relative
  rank 0's checkpoint params vs roc_tpu's trainer            1e-5 absolute
                                                             (1e-3 of lr)
  world of one vs the port's single process                  1e-5 relative
  world of one vs roc_tpu's trainer                          1e-5 relative
                                                             (1e-4 on the
                                                             bf16 wire)
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.models import build_model as jbuild
from roc_tpu.parallel.spmd import SpmdTrainer as JSpmd
from roc_tpu.train import checkpoint as jcheckpoint
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.config import parse_args as jparse_args
from roc_tpu_torch.graph import datasets, lux, shard_load
from roc_tpu_torch.models import build_model
from roc_tpu_torch.parallel import collectives
from roc_tpu_torch.parallel.spmd import SpmdTrainer
from roc_tpu_torch.train.config import Config, parse_args
from roc_tpu_torch.train.driver import Trainer

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def world_of_one(monkeypatch):
    """This process as a gloo world of one."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    g = collectives.init_process_group("cpu")
    collectives.reset_launches()
    try:
        yield g
    finally:
        collectives.destroy_process_group()


def test_collectives_in_a_world_of_one(world_of_one):
    assert world_of_one.backend == "gloo" and world_of_one.world == 1
    x = torch.arange(12.0).view(6, 2).requires_grad_(True)
    g = torch.randn(6, 2)
    for fn in (collectives.all_to_all, collectives.all_gather,
               collectives.reduce_scatter, collectives.ring_hop):
        y = fn(x)
        assert torch.equal(y, x.detach())
        (dx,) = torch.autograd.grad(y, x, g)
        assert torch.equal(dx, g)
    m = collectives.all_reduce_max(torch.tensor([1.0, -2.0]))
    assert m.tolist() == [1.0, -2.0] and not m.requires_grad
    t = torch.tensor([3.0])
    assert collectives.all_reduce_sum_(t) is t and t.item() == 3.0
    collectives.barrier()
    n = collectives.launches()
    assert n["gloo:all_to_all"] == 2 and n["gloo:ring_hop"] == 2
    assert n["gloo:all_gather"] == 2 and n["gloo:reduce_scatter"] == 2
    assert n["gloo:barrier"] == 1


def test_torch_allgather_int64_safe(world_of_one):
    """int64 values past 2^31 survive the gather (shard_load's counts at
    pod scale; roc_tpu's test_jax_allgather_int64_safe)."""
    ag = shard_load.torch_allgather()
    x = np.array([3_200_000_000, -5, 0, 2**40 + 123, -(2**35)], np.int64)
    out = ag(x)
    assert out.dtype == np.int64 and out.shape == (1, 5)
    np.testing.assert_array_equal(out[0], x)
    y = np.arange(6, dtype=np.int32).reshape(2, 3)
    got = ag(y)
    assert got.dtype == np.int32 and np.array_equal(got[0], y)


def test_torch_allgather_needs_the_group():
    with pytest.raises(RuntimeError, match="process group"):
        shard_load.torch_allgather()


def test_only_rank0_writes_the_checkpoint(tmp_path, monkeypatch):
    """Process 0 writes; every process waits at the barrier after."""
    ds = datasets.get("roc-audit", seed=1)
    tr = Trainer(Config(layers=[8, 16, 4], device="cpu", eval_every=10**9),
                 ds, build_model("gcn", [8, 16, 4]))
    waits = []
    monkeypatch.setattr(collectives, "barrier", lambda: waits.append(1))
    for rank in (1, 0):
        tr.comm = collectives.Group(rank=rank, world=2, local_rank=rank,
                                    backend="gloo",
                                    device=torch.device("cpu"))
        path = str(tmp_path / f"r{rank}.npz")
        tr.save_checkpoint(path)
        assert os.path.exists(path) == (rank == 0)
    assert len(waits) == 2


def test_multihost_needs_torchrun_env(monkeypatch):
    for k in collectives.ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        collectives.process_device()
    monkeypatch.setenv("LOCAL_RANK", "3")
    for k in collectives.ENV:
        monkeypatch.setenv(k, os.environ.get(k, "0"))
    assert collectives.process_device("cuda") == "cuda:3"
    assert collectives.process_device("cpu") == "cpu"


# -- two processes over gloo ---------------------------------------------------

@pytest.fixture(scope="module")
def lux_prefix(tmp_path_factory):
    ds = datasets.synthetic("mh", 300, 4.0, 12, 5, n_train=80, n_val=60,
                            n_test=60, seed=7)
    prefix = str(tmp_path_factory.mktemp("mh") / "g")
    lux.write_dataset(prefix, ds.graph, ds.features, ds.label_ids, ds.mask)
    lux.write_transpose(prefix, ds.graph)
    return prefix


def _spawn(argv, obs_dir):
    """The CLI in two processes; returns each rank's (stdout, stderr)."""
    cmd = [sys.executable, "-m", "roc_tpu_torch", *argv, "-multihost",
           "-device", "cpu", "-obs", "-obs-dir", str(obs_dir)]
    last = None
    for _ in range(2):
        port = str(_free_port())
        procs = []
        for r in range(2):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=port, OMP_NUM_THREADS="1",
                       PYTHONPATH=str(ROOT))
            procs.append(subprocess.Popen(
                cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=DEADLINE_S) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            last = "hang"
            continue
        if all(p.returncode == 0 for p in procs):
            return outs
        last = outs
        if not any("address already in use" in e.lower() for _, e in outs):
            break
    pytest.fail(f"two-process run failed: {last}")


def _losses(obs_dir, rank):
    path = Path(obs_dir) / f"rank{rank}" / "metrics.jsonl"
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    return [r["loss"] for r in recs if r.get("type") == "metrics"]


def _infer_lines(out):
    return [line for line in out.splitlines() if "[INFER]" in line]


ARGS = ["-layers", "12-8-5", "-lr", "0.01", "-decay", "0.0005", "-parts",
        "4"]


def _single(prefix, argv):
    """The port's single-process SpmdTrainer at the same P (k = 1)."""
    cfg = parse_args(["-file", prefix, *argv, "-device", "cpu"])
    ds = datasets.load_roc_dataset(prefix, 12, 5,
                                   graph_stub=cfg.perhost_load)
    model = build_model(cfg.model, cfg.layers, cfg.dropout_rate, cfg.aggr,
                        heads=cfg.heads)
    return SpmdTrainer(cfg, ds, model, devices=["cpu"] * cfg.num_parts)


def _run(tr, epochs):
    """Each epoch's (loss, (train, val, test) correct counts)."""
    out = []
    for _ in range(epochs):
        loss = float(tr.run_epoch())
        m = tr.evaluate()
        out.append((loss, tuple(int(getattr(m, f)) for f in
                                ("train_correct", "val_correct",
                                 "test_correct"))))
    return out


def _roc_tpu(prefix, argv, epochs):
    """roc_tpu's single-process SpmdTrainer at the same P on the full
    graph (k = 1 over 8 host devices) and its ``_run``."""
    cfg = jparse_args(["-file", prefix, *[a for a in argv if a !=
                                          "-perhost"], "-aggr-backend",
                       "xla"])
    jds = jdatasets.load_roc_dataset(prefix, 12, 5)
    tr = JSpmd(cfg, jds, jbuild(cfg.model, cfg.layers, cfg.dropout_rate,
                                cfg.aggr, heads=cfg.heads))
    return tr, _run(tr, epochs)


_COUNTS = re.compile(r"\[INFER\]\[(\d+)\].*?\((\d+)/\d+\).*?\((\d+)/\d+\)"
                     r".*?\((\d+)/\d+\)")


def _check_ranks(outs, obs_dir, want, start=0):
    """Both ranks' losses equal, and ``want``'s within 1e-5; the counts of
    every printed [INFER] line equal ``want``'s at that epoch."""
    l0, l1 = _losses(obs_dir, 0), _losses(obs_dir, 1)
    assert l0 == l1
    np.testing.assert_allclose(l0, [w[0] for w in want], rtol=1e-5)
    lines = _infer_lines(outs[0][0])
    assert lines and lines == _infer_lines(outs[1][0])
    for line in lines:
        e, *counts = (int(v) for v in _COUNTS.search(line).groups())
        assert tuple(counts) == want[e - start][1], line


@pytest.fixture(scope="module")
def halo_run(lux_prefix, tmp_path_factory):
    """-perhost halo at dropout 0.5, 3 epochs, rank 0 checkpointing."""
    d = tmp_path_factory.mktemp("halo")
    ckpt = str(d / "ck.npz")
    argv = ["-file", lux_prefix, *ARGS, "-perhost", "-dropout", "0.5",
            "-e", "3", "-ckpt", ckpt]
    outs = _spawn(argv, d / "obs")
    return argv, outs, d / "obs", ckpt


def test_two_process_perhost_halo_matches_one_process(lux_prefix, halo_run):
    argv, outs, obs_dir, ckpt = halo_run
    ref, want = _roc_tpu(lux_prefix, argv[2:-2], 3)
    assert ref.gdata.mode == "vertex"
    _check_ranks(outs, obs_dir, want)
    one = _single(lux_prefix, argv[2:-2])
    for _ in range(3):
        one.run_epoch()
    params, _, epoch, _, _ = jcheckpoint.load(ckpt, ref.params,
                                              ref.opt_state)
    assert epoch == 3
    for k in ref.params:
        got = np.asarray(params[k])
        np.testing.assert_allclose(got, one.params[k].numpy(), rtol=1e-5,
                                   atol=1e-7)
        # Adam moves an element whose gradient is at rounding level by up
        # to lr (0.01) a step, so roc_tpu's params are held at 1e-3 lr
        np.testing.assert_allclose(got, np.asarray(ref.params[k]), rtol=0,
                                   atol=1e-5)


def test_two_process_ring_resumes_rank0_checkpoint(lux_prefix, halo_run,
                                                   tmp_path):
    """Both ranks restore rank 0's checkpoint, then train the ring."""
    ckpt = str(tmp_path / "ck.npz")
    with open(halo_run[3], "rb") as f, open(ckpt, "wb") as g:
        g.write(f.read())
    argv = ["-file", lux_prefix, *ARGS, "-exchange", "ring", "-dropout",
            "0.5", "-e", "2", "-eval-every", "1", "-ckpt", ckpt, "-resume"]
    outs = _spawn(argv, tmp_path / "obs")
    ref = _single(lux_prefix, argv[2:-3])
    ref.restore(halo_run[3])
    assert ref.epoch == 3 and ref.gdata.mode == "ring"
    _check_ranks(outs, tmp_path / "obs", _run(ref, 2), start=3)


def test_two_process_edge_shard_with_the_sidecar(lux_prefix, tmp_path):
    argv = ["-file", lux_prefix, *ARGS, "-edge-shard", "on", "-perhost",
            "-dropout", "0.0", "-e", "3", "-v"]
    outs = _spawn(argv, tmp_path / "obs")
    ref, want = _roc_tpu(lux_prefix, argv[2:], 3)
    assert ref.gdata.mode == "edge"
    _check_ranks(outs, tmp_path / "obs", want)
    # banners from process 0 only
    assert "# edge blocks: P=4" in outs[0][1]
    assert "# edge blocks" not in outs[1][1]


def test_cli_refusals_come_before_the_group(capsys, monkeypatch):
    """roc_tpu's CLI refusals (roc_tpu/__main__.py:29-70) exit with its
    reasons before any process group starts (no torchrun variables set)."""
    from roc_tpu_torch.__main__ import main
    for k in collectives.ENV:
        monkeypatch.delenv(k, raising=False)
    base = ["-dataset", "roc-audit", "-layers", "8-16-4", "-device", "cpu"]
    assert main(base + ["-stream", "-parts", "4", "-multihost"]) == 2
    assert main(base + ["-stream", "-parts", "1"]) == 2
    assert main(base + ["-stream", "-parts", "4", "-bf16"]) == 2
    err = capsys.readouterr().err
    assert "-stream is single-process — it trades host memory" in err
    assert "-stream needs -parts >= 2 (shards rotate" in err
    assert "-stream computes in fp32; the streamed storage cut" in err
    assert collectives.group() is None
    with pytest.raises(SystemExit, match="torchrun"):
        main(base + ["-parts", "4", "-multihost"])


_MODES = {"halo": dict(), "allgather": dict(exchange="allgather"),
          "ring": dict(exchange="ring"), "edge": dict(edge_shard="on")}
_WIRE = dict(bf16_storage=True, bf16_rounding="stochastic",
             aggregate_precision="fast")


def _roc_tpu_audit(name, wire):
    """roc_tpu's SpmdTrainer on roc-audit at P = 4, dropout 0.5: three
    epochs' losses and the train loss after them."""
    kw = dict(_MODES[name], **(_WIRE if wire else {}))
    kw.setdefault("edge_shard", "off")
    cfg = JConfig(layers=[8, 16, 4], num_parts=4, dropout_rate=0.5,
                  eval_every=10**9, learning_rate=0.01, weight_decay=5e-4,
                  aggregate_backend="xla", **kw)
    tr = JSpmd(cfg, jdatasets.get("roc-audit", seed=1),
               jbuild("gcn", [8, 16, 4], 0.5))
    return ([float(tr.run_epoch()) for _ in range(3)]
            + [float(tr.evaluate().train_loss)])


@pytest.mark.parametrize("mode", ["halo", "allgather", "ring", "edge",
                                  "halo_bf16", "allgather_bf16",
                                  "ring_bf16"])
def test_world_of_one_trains_as_one_process(world_of_one, mode):
    """-multihost at W = 1 runs every exchange through the collectives
    (all_to_all, all_gather, the ring hop, edge mode's gather, max and
    reduce-scatter) and trains as the port's single-process trainer at the
    same P (1e-5; at dropout 0.5, the masks of the global positions) and
    as roc_tpu's (1e-5; 1e-4 on the bf16 wire, as test_torch_ring.py and
    test_torch_spmd.py hold it)."""
    ds = datasets.get("roc-audit", seed=1)
    name, _, wire = mode.partition("_")
    kw = dict(_MODES[name], **(_WIRE if wire else {}))
    runs = []
    for mh in (True, False):
        cfg = Config(layers=[8, 16, 4], num_parts=4, dropout_rate=0.5,
                     device="cpu", eval_every=10**9, multihost=mh,
                     learning_rate=0.01, weight_decay=5e-4, **kw)
        tr = SpmdTrainer(cfg, ds, build_model("gcn", [8, 16, 4], 0.5),
                         devices=None if mh else ["cpu"] * 4)
        assert (tr.comm is not None) == mh and tr.k == 1
        runs.append([float(tr.run_epoch()) for _ in range(3)]
                    + [float(tr.evaluate().train_loss)])
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)
    np.testing.assert_allclose(runs[0], _roc_tpu_audit(name, wire),
                               rtol=1e-4 if wire else 1e-5)
    n = collectives.launches()
    assert n["gloo:all_reduce_sum"] >= 4
    hop = {"halo": "gloo:all_to_all", "allgather": "gloo:all_gather",
           "ring": "gloo:ring_hop", "edge": "gloo:reduce_scatter"}[name]
    assert n[hop] > 0


def test_single_device_trainer_under_multihost(world_of_one, tmp_path):
    """-multihost -parts 1: the single-device trainer on each process, as
    roc_tpu's on a one-part mesh; process 0 writes the checkpoint."""
    from roc_tpu_torch.train.driver import make_trainer
    ds = datasets.get("roc-audit", seed=1)
    cfg = Config(layers=[8, 16, 4], device="cpu", eval_every=10**9,
                 multihost=True)
    tr = make_trainer(cfg, ds, build_model("gcn", [8, 16, 4]))
    assert type(tr) is Trainer and tr.comm is world_of_one
    ref = Trainer(Config(layers=[8, 16, 4], device="cpu", eval_every=10**9),
                  ds, build_model("gcn", [8, 16, 4]))
    assert float(tr.run_epoch()) == float(ref.run_epoch())
    tr.save_checkpoint(str(tmp_path / "c.npz"))
    assert os.path.exists(tmp_path / "c.npz")
    assert collectives.launches()["gloo:barrier"] == 1
