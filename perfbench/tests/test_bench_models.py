"""A model is a set of files found by the name its configuration gives
under ``reference``: the leaves the harness draws and the work it counts
a step come from that model module, and set-up stops where the drawn
leaves are not the port's parameters."""

import copy
import math
import sys
import types

import pytest
import torch

from perfbench import counts, inputs, port, spec, train_run
from perfbench.tests.conftest import run_tiny, tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
N, E = 232965, 23526073

# Pinned: every cell's history was read with these leaves (names, shapes,
# Glorot fans, draw order) and these counts at Reddit's N and E, so a
# model module that moves one moves the yardstick.
PINNED_LEAVES = {
    "gcn-reddit": [("linear_0", (602, 256), 602, 256),
                   ("linear_1", (256, 41), 256, 41)],
    "gat8x8-reddit": [("gat_0_w", (602, 64), 602, 64),
                      ("gat_0_asrc", (8, 8), 64, 1),
                      ("gat_0_adst", (8, 8), 64, 1),
                      ("gat_1_w", (64, 41), 64, 41),
                      ("gat_1_asrc", (1, 41), 41, 1),
                      ("gat_1_adst", (1, 41), 41, 1)],
}
PINNED_COUNTS = {
    ("gcn-reddit", True): {
        "flops": 172256499522.0, "gemm_flops": 158282012160,
        "sum_flops": 13974487362.0, "gat_flops": 0.0,
        "sum_least_s": 0.000445051271641791, "gat_least_s": 0.0},
    ("gcn-reddit", False): {
        "flops": 83683049121.0, "gemm_flops": 76695805440,
        "sum_flops": 6987243681.0, "gat_flops": 0.0,
        "sum_least_s": 0.00022252563582089553, "gat_least_s": 0.0},
    ("gat8x8-reddit", True): {
        "flops": 56631582225.0, "gemm_flops": 39570503040,
        "sum_flops": 0.0, "gat_flops": 17061079185.0,
        "sum_least_s": 0.0, "gat_least_s": 0.0003261796299701493},
    ("gat8x8-reddit", False): {
        "flops": 25295406600.0, "gemm_flops": 19173951360,
        "sum_flops": 0.0, "gat_flops": 6121455240.0,
        "sum_least_s": 0.0, "gat_least_s": 0.0001574346447761194},
}
CONFIG_CELL = {"gcn-reddit": "gcn-reddit.train",
               "gat8x8-reddit": "gat8x8-reddit.train"}


def _config(name):
    return spec.cell(CONFIG_CELL[name]).config


def _tiny(cell="gcn-reddit.train", **over):
    c = tiny_cell(cell)
    c.config.update(copy.deepcopy(over))
    return c


def _port_leaves(cfg):
    """The port trainer's own parameters, (name, shape) in its order."""
    from roc_tpu_torch.train.driver import Trainer
    conf, model = port.build(cfg, SEED, CPU, eval_every=1 << 30)
    ds, _ = inputs.for_port(cfg, SEED, CPU)
    return [(k, tuple(v.shape)) for k, v in
            Trainer(conf, ds, model).params.items()]


@pytest.mark.parametrize("name", sorted(PINNED_LEAVES))
def test_leaves_are_the_pinned_ones(name):
    assert inputs.weight_shapes(_config(name)) == PINNED_LEAVES[name]


@pytest.mark.parametrize("name", sorted(PINNED_LEAVES))
def test_weights_are_one_flat_draw_over_the_pinned_leaves(name):
    cfg = _config(name)
    got = inputs.make_weights(cfg, SEED, CPU)
    leaves = PINNED_LEAVES[name]
    total = sum(math.prod(s) for _, s, _, _ in leaves)
    g = inputs._generator(SEED, CPU, 4)
    flat = torch.rand(total, generator=g).mul_(2.0).sub_(1.0)
    off = 0
    assert list(got) == [k for k, _, _, _ in leaves]
    for k, shape, fan_in, fan_out in leaves:
        n = math.prod(shape)
        want = flat[off:off + n] * math.sqrt(6.0 / (fan_in + fan_out))
        assert torch.equal(got[k], want.reshape(shape))
        off += n


@pytest.mark.parametrize("name,train", sorted(PINNED_COUNTS))
def test_counts_are_the_pinned_ones_to_the_bit(name, train):
    got = counts.step_counts(_config(name), N, E, train)
    want = PINNED_COUNTS[(name, train)]
    assert list(got) == list(want)
    assert {k: float(v).hex() for k, v in got.items()} == \
        {k: float(v).hex() for k, v in want.items()}


@pytest.mark.parametrize("cell,model,layers", [
    ("gcn-reddit.train", "gcn", [16, 8, 5]),
    ("gcn-reddit.train", "gcn-chain", [16, 8, 8, 8, 5]),
    ("gat8x8-reddit.train", "gat", [16, 8, 5]),
    ("gat8x8-reddit.train", "gat", [16, 4, 6, 5]),
])
def test_leaves_are_the_trainers_parameters(cell, model, layers):
    cfg = _tiny(cell, model=model, layers=layers).config
    assert [(k, s) for k, s, _, _ in inputs.weight_shapes(cfg)] == \
        _port_leaves(cfg)
    tr, _ = train_run.build_trainer(cfg, SEED, CPU)
    assert math.isfinite(float(tr.run_epoch()))


@pytest.mark.parametrize("cell", ["gcn-reddit.train",
                                  "gcn-reddit.serve-churn"])
def test_a_deep_gcn_is_refused_at_setup(cell, monkeypatch):
    """A gcn of four layers has a residual linear a layer, which
    ``reference: gcn`` lacks: the run stops before its first step or
    query, naming the leaves."""
    from roc_tpu_torch.serve import ServeEngine
    from roc_tpu_torch.train.driver import Trainer
    called = []
    monkeypatch.setattr(Trainer, "run_epoch", lambda s: called.append(s))
    monkeypatch.setattr(ServeEngine, "warmup", lambda s: called.append(s))
    c = _tiny(cell, layers=[16, 8, 8, 8, 5])
    with pytest.raises(SystemExit) as err:
        run_tiny(c, seconds=0.2)
    msg = str(err.value)
    assert "missing linear_7 (8, 5)" in msg
    assert "misshapen linear_1 (8, 8), the port's (16, 8)" in msg
    assert not called


def test_a_mismatch_names_missing_extra_and_misshapen_leaves():
    own = {"a": torch.zeros(2, 3), "b": torch.zeros(4)}
    drawn = {"a": torch.zeros(3, 2), "c": torch.zeros(1)}
    with pytest.raises(SystemExit, match=r"missing b \(4,\); misshapen a "
                       r"\(3, 2\), the port's \(2, 3\); extra c \(1,\)"):
        port.leaves_for(own, drawn, CPU)
    got = port.leaves_for(own, {"b": torch.ones(4), "a": torch.ones(2, 3)},
                          CPU)
    assert list(got) == ["b", "a"]


def test_a_model_without_heads_counts_one_head():
    """``_widths`` takes the heads from its caller: a configuration that
    carries ``heads`` counts GCN's work at one head a layer."""
    cfg = _config("gcn-reddit")
    headed = dict(cfg, heads=8)
    assert inputs.weight_shapes(headed) == inputs.weight_shapes(cfg)
    assert counts.step_counts(headed, N, E, True) == \
        counts.step_counts(cfg, N, E, True)
    assert counts._widths(headed, 1) == [(602, 256, 1, 256),
                                         (256, 41, 1, 41)]
    assert counts._widths(headed, 8)[0] == (602, 2048, 8, 256)
    with pytest.raises(TypeError):
        counts._widths(cfg)


def _toy_sage():
    """A model module for the port's ``sage``: two linears a layer
    (``linear_2i`` on the node, ``linear_2i+1`` on the in-edge mean), the
    sums at the layer's input width."""
    mod = types.ModuleType("perfbench.reference.toy_sage")

    def leaves(cfg):
        out = []
        for i, (din, dout, _, _) in enumerate(counts._widths(cfg, heads=1)):
            for j in (2 * i, 2 * i + 1):
                out.append((f"linear_{j}", (din, dout), din, dout))
        return out

    def model_counts(cfg, n, e, train):
        widths = counts._widths(cfg, heads=1)
        sums = least = 0.0
        for din, _, _, _ in widths:
            ops, nbytes = counts.sum_call(n, e, din)
            sums += ops * (2 if train else 1)
            least += counts.least_s(ops, nbytes) * (2 if train else 1)
        return counts.step_totals(2 * counts.gemm_flops(widths, n, train),
                                  sum_flops=sums, sum_least_s=least)

    mod.leaves, mod.counts = leaves, model_counts
    return mod


def test_a_new_model_module_is_drawn_and_counted(monkeypatch):
    """A module under ``perfbench.reference`` and a configuration naming
    it: the harness draws its leaves, the port trains on them, and the
    metric readers count its work."""
    mod = _toy_sage()
    monkeypatch.setitem(sys.modules, "perfbench.reference.toy_sage", mod)
    cfg = _tiny(model="sage", reference="toy_sage").config
    leaves = mod.leaves(cfg)
    w = inputs.make_weights(cfg, SEED, CPU)
    assert [(k, tuple(v.shape)) for k, v in w.items()] == \
        [(k, s) for k, s, _, _ in leaves] == _port_leaves(cfg)
    tr, _ = train_run.build_trainer(cfg, SEED, CPU)
    assert tr.config.model == "sage"
    assert math.isfinite(float(tr.run_epoch()))
    c = counts.step_counts(cfg, N, E, True)
    assert c == mod.counts(cfg, N, E, True)
    run = {"kind": "train", "cfg": cfg, "nodes": N, "edges": E,
           "steps": 10, "trace": {"window_s": 2.0, "kernels": {
               "void sum_rows<float, 4>(long const*)": 0.5}}}
    assert spec.metric_reader("mfu.train")(run) == pytest.approx(
        100.0 * c["flops"] * 10 / 2.0 / counts.PEAK_FLOPS)
    assert spec.metric_reader("sum_roofline.train")(run) == pytest.approx(
        100.0 * c["sum_least_s"] * 10 / 0.5)
