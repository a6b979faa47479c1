"""The port's memory planner (roc_tpu_torch.memory) against roc_tpu's, on
the same models, shapes, estimates and parameters, on the CPU.

Tolerances:
  estimator byte fields, fixed bytes, roofline FLOPs/bytes   equal
  planner decisions and to_json on one shared estimate        byte-equal
  DP vs brute force                                           1e-12 s
  planned (remat, auto) vs keep trainer, 3 epochs             bitwise
  planned trainer vs roc_tpu's under the same plan            1e-5 relative
  plan-dump CLI byte fields                                   equal
"""

import contextlib
import dataclasses
import io
import itertools
import json

import numpy as np
import pytest
import torch

from roc_tpu.graph import datasets as jdatasets
from roc_tpu.memory import __main__ as jmem_cli
from roc_tpu.memory import estimator as jest
from roc_tpu.memory import planner as jplan
from roc_tpu.models import build_model as jbuild
from roc_tpu.obs import roofline as jroof
from roc_tpu.obs.watchdog import PerfWatchdog as JWatchdog
from roc_tpu.train.config import Config as JConfig
from roc_tpu.train.driver import make_trainer as jmake_trainer
from roc_tpu_torch.graph import datasets
from roc_tpu_torch.memory import __main__ as mem_cli
from roc_tpu_torch.memory import estimator, planner, policy
from roc_tpu_torch.memory.estimator import LayerEstimate, ModelEstimate
from roc_tpu_torch.memory.planner import KEEP, OFFLOAD, REMAT
from roc_tpu_torch.models import build_model
from roc_tpu_torch.obs import roofline
from roc_tpu_torch.obs.watchdog import PerfWatchdog
from roc_tpu_torch.train.config import Config, parse_size
from roc_tpu_torch.train.driver import make_trainer

MODELS = ["gcn", "gcn-chain", "sage", "gin", "gat"]
LAYERS = [32, 16, 16, 16, 8]


@pytest.fixture(autouse=True)
def _binned_runs_under_jax_0_9():
    """run_binned's one-shot eager warning calls jax.core.trace_state_clean,
    which jax 0.9.0 no longer exports (ROADMAP queue C)."""
    from roc_tpu.ops.pallas import binned
    old = binned._EAGER_WARNED
    binned._EAGER_WARNED = True
    yield
    binned._EAGER_WARNED = old


def _models(name, layers=LAYERS, dropout=0.5):
    return (jbuild(name, layers, dropout, "", heads=2),
            build_model(name, layers, dropout, heads=2))


def _bytes(est):
    return (est.fixed_bytes, est.rows, est.edges,
            [(l.index, l.name, l.bytes_full, l.bytes_saved,
              l.bytes_boundary) for l in est.layers])


def _to_port(est) -> ModelEstimate:
    """A roc_tpu ModelEstimate as the port's (the same fields)."""
    return ModelEstimate(
        layers=tuple(LayerEstimate(**dataclasses.asdict(l))
                     for l in est.layers),
        fixed_bytes=est.fixed_bytes, base_step_s=est.base_step_s,
        rows=est.rows, edges=est.edges)


# -- the model's checkpoint stamps -----------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_ops_carry_roc_tpu_checkpoint_stamps(name):
    jm, pm = _models(name)
    keys = ("layer", "ckpt", "ckpt_save", "ckpt_boundary")
    assert [{k: op.attrs.get(k) for k in keys} for op in pm.ops] == \
        [{k: op.attrs.get(k) for k in keys} for op in jm.ops]


# -- estimator --------------------------------------------------------------

@pytest.mark.parametrize("fuse", [(False, 1), (True, 1), (True, 0)],
                         ids=["unfused", "megafuse", "depth0"])
@pytest.mark.parametrize("name", MODELS)
def test_estimator_bytes_equal_roc_tpu(name, fuse):
    jm, pm = _models(name)
    rows, edges = 1000, 9000
    jfixed = jest.fixed_bytes_for(jm, rows, 32, 8, edges)
    pfixed = estimator.fixed_bytes_for(pm, rows, 32, 8, edges)
    assert pfixed == jfixed
    a = jest.estimate_model(jm, rows, edges, fixed_bytes=jfixed,
                            megafuse=fuse[0], fusion_depth=fuse[1])
    b = estimator.estimate_model(pm, rows, edges, fixed_bytes=pfixed,
                                 megafuse=fuse[0], fusion_depth=fuse[1])
    assert _bytes(b) == _bytes(a)
    assert estimator.mega_bwd_cotangent_drop(pm, rows) == \
        jest.mega_bwd_cotangent_drop(jm, rows)
    assert estimator.gat_residual_drop(pm, rows, edges) == \
        jest.gat_residual_drop(jm, rows, edges)
    # recompute is priced for the card, so only its structure carries over
    for l in b.layers:
        assert 0.0 <= l.recompute_cheap_s < l.recompute_full_s


def test_port_residents_reported_apart():
    """The port's own residents: the CSR and its transpose (int64 row
    pointer + int32 sources each), GAT's edge map, the widest fast
    staging plane; roc_tpu's two edge arrays come out."""
    _, pm = _models("gat", [32, 8, 8])
    got = estimator.port_resident_bytes(pm, 1000, 9000, "fast", True)
    assert got == {"csr": 1001 * 8 + 9000 * 4, "csr_t": 1001 * 8 + 9000 * 4,
                   "t_pos": 9000 * 4, "stage_plane": 0,
                   "edge_arrays": -9000 * 8}
    _, pm = _models("gcn", [32, 16, 8])
    got = estimator.port_resident_bytes(pm, 1000, 9000, "fast")
    assert got["stage_plane"] == 1000 * 16 * 2 and got["t_pos"] == 0
    assert estimator.port_resident_bytes(
        pm, 1000, 9000, "exact")["stage_plane"] == 0


@pytest.mark.parametrize("name", MODELS)
def test_roofline_flops_bytes_equal_roc_tpu(name):
    jm, pm = _models(name)
    for prec in ("fast", "exact"):
        assert roofline.model_flops_bytes(pm, 1000, 9000, prec) == \
            jroof.model_flops_bytes(jm, 1000, 9000, prec)
        assert roofline.forward_flops_bytes(pm, 1000, 9000, prec) == \
            jroof.forward_flops_bytes(jm, 1000, 9000, prec)
    # the card's peaks, not the TPU's
    assert (roofline.PEAK_FLOPS, roofline.PEAK_BW) == (67e12, 3.35e12)


# -- planner ----------------------------------------------------------------

def _shared_estimate(name, rows=612_258, edges=31_250_000):
    jm, _ = _models(name, [100, 256, 256, 47])
    fixed = jest.fixed_bytes_for(jm, rows, 100, 47, edges)
    return jest.estimate_model(jm, rows, edges, fixed_bytes=fixed)


@pytest.mark.parametrize("budget", ["0", "2g", "6g", "8g", "12g"])
@pytest.mark.parametrize("mode", ["auto", "keep", "remat"])
@pytest.mark.parametrize("name", ["gcn", "gat", "sage"])
def test_plan_json_equal_roc_tpu_on_shared_estimate(name, mode, budget):
    jest_ = _shared_estimate(name)
    b = parse_size(budget)
    for stream, spill in ((False, False), (True, False), (True, True)):
        want = jplan.plan_memory(jest_, mode, b, stream, spill)
        got = planner.plan_memory(_to_port(jest_), mode, b, stream, spill)
        assert got.to_json() == want.to_json()
        assert got.summary() == want.summary()


def _synthetic_estimate(rng, L):
    layers = []
    for i in range(L):
        full = int(rng.integers(8, 100)) * 1024
        saved = int(full * rng.uniform(0.3, 0.9))
        fwd = float(rng.uniform(0.5, 5.0))
        layers.append(LayerEstimate(
            index=i, name=f"L{i}", bytes_full=full, bytes_saved=saved,
            bytes_boundary=saved // 2, recompute_full_s=fwd,
            recompute_cheap_s=fwd * float(rng.uniform(0.05, 0.4))))
    return ModelEstimate(layers=tuple(layers), fixed_bytes=16 * 1024,
                         base_step_s=3.0 * sum(l.recompute_full_s
                                               for l in layers),
                         rows=0, edges=0)


@pytest.mark.parametrize("L", range(2, 7))
def test_dp_matches_brute_force(L):
    """The DP's plan is the least predicted time among all feasible
    KEEP/REMAT vectors (full enumeration), within 1e-12 s."""
    rng = np.random.default_rng(100 + L)
    for _ in range(6):
        est = _synthetic_estimate(rng, L)
        keep_peak = planner.predict_peak(est, [KEEP] * L)
        remat_peak = planner.predict_peak(est, [REMAT] * L)
        for frac in (0.0, 0.35, 0.6, 0.85, 1.1):
            budget = int(remat_peak + frac * (keep_peak - remat_peak)) \
                if frac else int(remat_peak * 0.9)
            plan = planner.plan_memory(est, mode="auto", budget_bytes=budget)
            best = None
            for dec in itertools.product((KEEP, REMAT), repeat=L):
                if planner.feasible(est, dec, budget):
                    t = planner.predict_time(est, dec)
                    best = t if best is None else min(best, t)
            if best is None:
                assert not plan.feasible
                assert all(d != KEEP for d in plan.decisions)
                continue
            assert plan.feasible
            assert planner.predict_time(est, plan.decisions) <= best + 1e-12


def test_greedy_fallback_past_dp_max_layers():
    rng = np.random.default_rng(7)
    L = planner.DP_MAX_LAYERS + 4
    est = _synthetic_estimate(rng, L)
    budget = int(0.7 * planner.predict_peak(est, [KEEP] * L))
    plan = planner.plan_memory(est, mode="auto", budget_bytes=budget)
    assert plan.planner == "greedy" and plan.feasible
    jest_ = jplan.ModelEstimate(
        layers=tuple(jest.LayerEstimate(**dataclasses.asdict(l))
                     for l in est.layers),
        fixed_bytes=est.fixed_bytes, base_step_s=est.base_step_s,
        rows=0, edges=0)
    assert plan.to_json() == jplan.plan_memory(
        jest_, mode="auto", budget_bytes=budget).to_json()


def test_plan_json_deterministic():
    est = _to_port(_shared_estimate("gcn"))
    a = planner.plan_memory(est, "auto", 8 << 30).to_json()
    b = planner.plan_memory(est, "auto", 8 << 30).to_json()
    assert a == b and json.loads(a)["decisions"]


def test_device_probes_on_the_cpu():
    assert planner.device_budget_bytes("cpu") == 0
    assert planner.measured_peak_bytes("cpu") is None


# -- the plan-dump CLI --------------------------------------------------------

def _cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


_BYTE_FIELDS = ("budget_bytes", "keep_peak_bytes", "remat_peak_bytes",
                "layer_names", "mode", "planner")


@pytest.mark.parametrize("argv", [[], ["--mode", "keep"], ["--mode", "remat"],
                                  ["--model", "gat"], ["--budget", "2g"],
                                  ["--budget", "64g"],
                                  ["--stream", "--budget", "6g"],
                                  ["--model", "sage", "--layers",
                                   "100-64-64-64-47"]])
def test_plan_cli_equals_roc_tpu(argv):
    """Byte fields equal; so is the set of KEEP layers.  A non-KEEP layer
    is "offload" in roc_tpu's dump where its TPU-priced recompute is slower
    than a PCIe round trip; the card's recompute is ~30x cheaper, so the
    port's dump says "remat" there.  Where no layer remats the dumps are
    byte-equal but for the step times."""
    a = json.loads(_cli(jmem_cli.main, argv))
    b = json.loads(_cli(mem_cli.main, argv))
    assert {k: b[k] for k in _BYTE_FIELDS} == {k: a[k] for k in _BYTE_FIELDS}
    assert [d == KEEP for d in b["decisions"]] == \
        [d == KEEP for d in a["decisions"]]
    if KEEP in a["decisions"] and set(a["decisions"]) == {KEEP}:
        assert b["decisions"] == a["decisions"]
        assert b["predicted_peak_bytes"] == a["predicted_peak_bytes"]
    if a["planner"] != "dp" or set(a["decisions"]) <= {KEEP, REMAT}:
        assert b["predicted_peak_bytes"] == a["predicted_peak_bytes"]
    assert _cli(mem_cli.main, argv) == _cli(mem_cli.main, argv)


# -- config -------------------------------------------------------------------

@pytest.mark.parametrize("env,field,want", [
    ("ROC_MEM_PLAN", "mem_plan", "remat"),
    ("ROC_MEM_BUDGET", "mem_budget", "3g"),
    ("ROC_STREAM", "stream", True),
    ("ROC_STREAM_SLOTS", "stream_slots", 3),
    ("ROC_STREAM_BUDGET", "stream_budget", "512m")])
def test_env_mirrors_match_roc_tpu(monkeypatch, env, field, want):
    raw = {True: "1"}.get(want, str(want))
    monkeypatch.setenv(env, raw)
    assert getattr(Config(layers=[8, 4]), field) == want
    assert getattr(JConfig(layers=[8, 4]), field) == want


@pytest.mark.parametrize("kw,env,match", [
    (dict(mem_plan="some"), {}, "bad mem_plan"),
    (dict(mem_budget="3q"), {}, "bad byte-size"),
    ({}, {"ROC_MEM_BUDGET": "x"}, "bad byte-size"),
    (dict(stream_budget="1.5.g"), {}, "bad byte-size"),
    (dict(stream_slots=1), {}, "needs >= 2 slots"),
    ({}, {"ROC_STREAM_SLOTS": "two"}, "must be an integer"),
    (dict(stream_spill="/tmp/x"), {}, "requires -stream"),
    ({}, {"ROC_STREAM_SPILL": "/tmp/x"}, "requires -stream")])
def test_config_refusals_match_roc_tpu(monkeypatch, kw, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match) as got:
        Config(layers=[8, 4], **kw)
    with pytest.raises(SystemExit) as want:
        JConfig(layers=[8, 4], **kw)
    assert str(got.value) == str(want.value)


def test_cli_flags_match_roc_tpu():
    from roc_tpu.train.config import parse_args as jparse
    from roc_tpu_torch.train.config import parse_args
    argv = ["-layers", "8-4", "-mem-plan", "auto", "-mem-budget", "6g",
            "-stream", "-ng", "3", "-stream-slots", "3",
            "-stream-budget", "2g", "-stream-spill", "/tmp/s"]
    a, b = jparse(argv), parse_args(argv)
    for f in ("mem_plan", "mem_budget", "stream", "num_parts",
              "stream_slots", "stream_budget", "stream_spill"):
        assert getattr(b, f) == getattr(a, f), f
    assert b.mem_budget_bytes() == a.mem_budget_bytes() == 6 << 30
    assert b.stream_budget_bytes() == a.stream_budget_bytes() == 2 << 30
    assert parse_args(["-layers", "8-4", "-ll:gpu", "2"]).num_parts == 2


# -- the policy in training ---------------------------------------------------

def _trainer(name, plan, budget="", dropout=0.5, epochs=3, layers=None):
    layers = layers or [8, 16, 16, 4]
    cfg = Config(dataset="roc-audit", layers=layers, num_epochs=epochs,
                 dropout_rate=dropout, model=name, heads=2, mem_plan=plan,
                 mem_budget=budget, device="cpu", eval_every=10**9)
    ds = datasets.get("roc-audit", seed=1)
    return make_trainer(cfg, ds, build_model(name, layers, dropout, heads=2))


def _run(tr, epochs=3):
    losses = [float(tr.run_epoch()) for _ in range(epochs)]
    return losses, {k: v.clone() for k, v in tr.params.items()}


def _halfway(name):
    tr = _trainer(name, "keep")
    p = tr.mem_plan
    return str((p.keep_peak_bytes + p.remat_peak_bytes) // 2)


@pytest.mark.parametrize("name", MODELS)
def test_planned_training_bitwise_equal_keep(name):
    """3 epochs at dropout 0.5: remat, and auto with a budget halfway
    between the keep and remat peaks, give keep's losses and parameters
    bit for bit (recompute re-draws the masks from their keys)."""
    want_l, want_p = _run(_trainer(name, "keep"))
    for plan, budget in (("remat", ""), ("auto", _halfway(name))):
        tr = _trainer(name, plan, budget)
        assert tr.mem_plan.any_remat(), (plan, tr.mem_plan.decisions)
        got_l, got_p = _run(tr)
        assert got_l == want_l, plan
        for k in want_p:
            assert torch.equal(got_p[k], want_p[k]), (plan, k)


@pytest.mark.parametrize("name", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("plan", ["remat", "auto"])
def test_planned_training_matches_roc_tpu(name, plan):
    """Under the same plan, 3 epochs at dropout 0.5 from the same seed:
    the port's losses within 1e-5 relative of roc_tpu's (both draw
    roc_tpu's parameters and masks)."""
    layers = [8, 16, 16, 4]
    tr = _trainer(name, plan, _halfway(name) if plan == "auto" else "",
                  layers=layers)

    def jtrainer(budget):
        jcfg = JConfig(dataset="roc-audit", layers=layers, num_epochs=3,
                       dropout_rate=0.5, model=name, heads=2, mem_plan=plan,
                       mem_budget=budget, eval_every=10**9)
        return jmake_trainer(jcfg, jdatasets.get("roc-audit", seed=1),
                             jbuild(name, layers, 0.5, "", heads=2))

    jtr = jtrainer("")
    if plan == "auto":  # halfway on roc_tpu's own estimate (no port residents)
        p = jtr.mem_plan
        jtr = jtrainer(str((p.keep_peak_bytes + p.remat_peak_bytes) // 2))
    assert tr.mem_plan.any_remat() and jtr.mem_plan.any_remat()
    want = [float(jtr.run_epoch()) for _ in range(3)]
    got = [float(tr.run_epoch()) for _ in range(3)]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)


def _saved_bytes(tr) -> int:
    """Bytes of the distinct storages autograd keeps for one training
    step's backward, counted through saved_tensors_hooks (a checkpoint's
    inputs pass the hook; the tensors inside it do not)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    params = {k: p.detach().requires_grad_(True)
              for k, p in tr.params.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tr._loss(params, tr.x, tr.labels, tr.mask, tr.gctx,
                        key=(0, 3), train=True)
    loss.backward()
    return sum(seen.values())


@pytest.mark.parametrize("name", ["gcn", "gcn-chain", "gat"])
def test_saved_tensor_bytes_fall_under_remat(name):
    keep = _saved_bytes(_trainer(name, "keep"))
    remat = _saved_bytes(_trainer(name, "remat"))
    auto = _saved_bytes(_trainer(name, "auto", _halfway(name)))
    # auto's KEEP layers save their linear, aggregate and boundary
    # outputs, which on these narrow widths can outweigh what autograd
    # keeps unplanned (a linear's input); remat saves the least
    assert remat < keep and remat <= auto, (keep, auto, remat)


def test_segments_cut_at_saved_tensors():
    """keep: no segment; remat: one per layer; a KEEP layer under an active
    plan ends a segment at each saved output (linear, aggregate, the
    boundary)."""
    tr = _trainer("gcn-chain", "remat")
    units = tr.model.units()
    runs = policy.segments(tr.model, tr.mem_plan, units)
    assert len(runs) == tr.model.num_layers
    mixed = dataclasses.replace(tr.mem_plan, decisions=(KEEP, REMAT, KEEP))
    runs = policy.segments(tr.model, mixed, units)
    ends = [run[-1].final.kind for run, _ in runs]
    assert ends == ["linear", "aggregate", "activation", "activation",
                    "linear", "aggregate", "norm"]
    # the boundary of a REMAT layer feeding the next is what the port's
    # checkpoints keep beyond the plan (reported as mem_crossing_bytes)
    assert policy.crossing_tids(tr.model, tr.mem_plan, units)
    assert tr.mem_crossing_bytes > 0


def test_offload_to_host_is_bitwise_and_labelled():
    """OFFLOAD layers under offload_to_host run unwrapped with their
    residuals in host memory; the gradients are keep's."""
    tr = _trainer("gcn", "keep")
    plan = dataclasses.replace(tr.mem_plan, decisions=(OFFLOAD, REMAT, KEEP),
                               offload_executes_as="stream-host")
    params = {k: p.detach().requires_grad_(True) for k, p in tr.params.items()}
    grads = []
    for fn in (tr.model.loss, policy.loss_fn(tr.model, plan, True),
               policy.loss_fn(tr.model, plan, False)):
        loss = fn(params, tr.x, tr.labels, tr.mask, tr.gctx, key=(0, 9),
                  train=True)
        grads.append(torch.autograd.grad(loss, list(params.values())))
    for g in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g, grads[0]))
    assert "offload executes-as-stream-host" in plan.summary()


def test_trainstats_carry_peak_hbm(monkeypatch):
    """TrainStats' peak fields carry roc_tpu's names: on the CPU the plan's
    prediction stands in (test_memory.py:227)."""
    monkeypatch.setenv("ROC_MEM_PLAN", "remat")
    tr = _trainer("gcn", "keep", epochs=2)
    stats = tr.train(print_fn=lambda *a, **k: None)
    assert len(stats.peak_hbm_bytes) == 2
    assert stats.peak_hbm_source == "estimated"
    assert all(b == tr.mem_plan.predicted_peak_bytes > 0
               for b in stats.peak_hbm_bytes)


def test_verbose_prints_plan_summary(capsys):
    cfg = Config(dataset="roc-audit", layers=[8, 16, 4], device="cpu",
                 mem_plan="remat", verbose=True)
    make_trainer(cfg, datasets.get("roc-audit", seed=1),
                 build_model("gcn", cfg.layers))
    assert "# mem-plan[remat/fixed] L0=remat L1=remat" in \
        capsys.readouterr().out


def test_step_arg_bytes_counts_placed_tensors():
    tr = _trainer("gcn", "keep")
    want = sum(t.numel() * t.element_size() for t in (
        *tr.params.values(), *tr.opt_state.m.values(),
        *tr.opt_state.v.values(), tr.x, tr.labels, tr.mask,
        tr.gdata.in_degree, *[c for c in tr.gdata.csr if c is not None]))
    assert estimator.step_arg_bytes(tr) == want


# -- the watchdog's stream feeds ----------------------------------------------

@pytest.mark.parametrize("feed", ["observe_stream", "observe_spill"])
def test_watchdog_stall_feeds_match_roc_tpu(feed):
    seq = [0.9, 0.01, 0.012, 0.011, 0.3, 0.013, 0.001, 0.5]
    a, b = JWatchdog(), PerfWatchdog()
    for e, f in enumerate(seq):
        assert getattr(b, feed)(e, f) == getattr(a, feed)(e, f)
    assert b.verdict() == a.verdict() != "ok"
    state = b.state_dict()
    c = PerfWatchdog()
    c.load_state(state)
    assert c.state_dict() == state
