"""GAT as published (Velickovic et al., ICLR 2018, arXiv 1710.10903,
Section 3.3: 8 heads of 8 features, concatenated, then ELU, then one head
of the classes; dropout 0.6), trained in "fast" through the port's normal
path (``Trainer.run_epoch`` on the binned backend, where the CPU runs the
GAT kernels' plain twins in the kernels' order) and held against the
benchmark's plain reference (``perfbench/reference/gat.py``) on the seed's
random weights, at a few hundred nodes: the eval logits, three steps'
losses, each leaf's first gradient and each leaf's change after the three
steps, element by element.  A reference with a planted fault fails the
same tolerances.  And the attention's spans, the kernel wrappers' sweep,
pass and head-loop counters, the src kernel's lane group, the dst kernel's
pass plan over dq and, on the card, the dst kernel's sums bitwise against
one-head launches and the src kernel's outputs bitwise across its lane
groups.

Tolerances (each a gap of the largest element, over the reference's
largest; read on five seeds, program against the scores-in-bf16 fault).
The two sides compute the same float32 function with the bfloat16
roundings at the same places (each product e * h[u] forward and e * du[v]
backward), so they part by float32 order alone: the source score (the
port's serial sum in feature order against an einsum), the sums' order,
the GEMMs' blocking.  A product that differs in its last float32 bit can
round to the other bfloat16 neighbour, 2^-8 of that term, so the logits
and gradients part by up to 2.2e-4 (LOGIT_TOL, GRAD_TOL 1e-3; the fault
2.1e-3 and 8.3e-3 at least).  The first loss parts by 6.6e-7 at most
(5e-6; the fault 3.2e-5); later steps' losses by 3.6e-5 (1e-4): the loss
falls steeply and amplifies the first step's rounding.  Adam moves each
element by about the learning rate whatever its gradient's size, so an
element whose gradient sits near 0 may step either way: the change parts
by 6.8e-3 (CHANGE_TOL 0.05; the fault 0.67).  A missing normaliser reads
near 1 everywhere."""

import contextlib
import copy
import json
import types

import pytest
import torch

from perfbench import inputs, reference, train_run
from perfbench.reference import gat as ref_gat
from perfbench.reference import prng as ref_prng
from perfbench.spec import HERE as BENCH_DIR
from roc_tpu_torch import obs
from roc_tpu_torch.ops.kernels import gat as gat_k

SEEDS = (2 ** 31 + 5, 7, 3000000019)
STEPS = 3
LOGIT_TOL = 1e-3
GRAD_TOL = 1e-3
CHANGE_TOL = 0.05
LOSS_TOLS = (5e-6, 1e-4, 1e-4)   # steps 1, 2, 3


def _cfg() -> dict:
    """The benchmark's configuration at its published widths but for the
    input (24 features) and the classes (5), on 400 nodes."""
    cfg = json.loads((BENCH_DIR / "configs" / "gat8x8-reddit.json")
                     .read_text())
    cfg["graph"].update(num_nodes=400, avg_degree=6.0, in_dim=24,
                        num_classes=5, n_train=200, n_val=80, n_test=80)
    cfg["layers"] = [24, 8, 5]
    assert (cfg["heads"], cfg["dropout"], cfg["precision"]) == (8, 0.6,
                                                                "fast")
    return cfg


def _port(cfg, seed):
    """The port's eval logits, then its three steps: losses, each leaf's
    first gradient as Adam got it and each leaf's change."""
    tr, _ = train_run.build_trainer(cfg, seed, torch.device("cpu"))
    logits = tr.predict_logits()
    w0 = {k: v.clone() for k, v in tr.params.items()}
    losses, grad1 = [], None
    for _ in range(STEPS):
        losses.append(float(tr.run_epoch()))
        if grad1 is None:
            b1 = tr.optimizer.beta1
            grad1 = {k: m / (1.0 - b1) for k, m in tr.opt_state.m.items()}
    change = {k: tr.params[k] - w0[k] for k in w0}
    return logits, losses, grad1, change


def _reference(cfg, seed):
    """The same from the plain reference (``reference.train_steps``'s loop,
    keeping the tensors)."""
    inp = inputs.make(cfg, seed, torch.device("cpu"))
    logits = reference.logits(cfg, inp.weights, inp)
    mod = reference.model_module(cfg)
    graph = reference.graph_for(cfg, inp.row_ptr, inp.col_idx, train=True)
    params = {k: v.clone() for k, v in inp.weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    base = ref_prng.key(seed)
    losses, grad1 = [], None
    for step in range(STEPS):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        out = mod.forward(leaves, inp.features, graph, cfg,
                          key=ref_prng.fold_in(base, step))
        loss = reference.ce_loss(out, inp.label_ids, inp.mask)
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params, m, v, gt = reference.adam(
                params, grads, m, v, step + 1, float(cfg["learning_rate"]),
                float(cfg["weight_decay"]))
        grad1 = gt if grad1 is None else grad1
    change = {k: params[k] - inp.weights[k] for k in params}
    return logits, losses, grad1, change


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest elementwise difference over the reference's largest
    element."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _gaps(port, ref) -> dict:
    (pl, ploss, pg, pc), (rl, rloss, rg, rc) = port, ref
    out = {"logits": _gap(pl, rl)}
    for i, (a, b) in enumerate(zip(ploss, rloss), 1):
        out[f"loss{i}"] = abs(a - b) / abs(b)
    for k in rg:
        out[f"grad:{k}"] = _gap(pg[k], rg[k])
        out[f"change:{k}"] = _gap(pc[k], rc[k])
    return out


def _within(gaps: dict) -> dict:
    """The gaps over their tolerance (empty when all hold)."""
    tol = {"logits": LOGIT_TOL, "grad": GRAD_TOL, "change": CHANGE_TOL}
    tol.update((f"loss{i}", t) for i, t in enumerate(LOSS_TOLS, 1))
    return {k: v for k, v in gaps.items()
            if not v <= tol[k.split(":")[0]]}


@pytest.fixture(scope="module")
def cfg():
    return _cfg()


@pytest.fixture(scope="module")
def port_runs(cfg):
    return {seed: _port(cfg, seed) for seed in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_follows_the_reference(cfg, port_runs, seed):
    gaps = _gaps(port_runs[seed], _reference(cfg, seed))
    assert len(gaps) == 1 + STEPS + 2 * 6
    assert not _within(gaps), gaps


def _faulty_attend(fault: str):
    """The reference's layer (``ref_gat.attend``) with one fault planted:
    its scores q rounded to bfloat16, or its softmax's division by the
    normaliser left out."""
    def attend(h, a_src, a_dst, graph, stage):
        n, k = h.shape[:2]
        src, dst = graph.src, graph.dst
        q = (torch.einsum("nkf,kf->nk", h, a_dst)[dst]
             + torch.einsum("nkf,kf->nk", h, a_src)[src])
        if fault == "scores_in_bf16":
            q = q.to(torch.bfloat16).to(torch.float32)
        s = torch.where(q >= 0, q, q * ref_gat.SLOPE)
        m = torch.full((n, k), float("-inf")).scatter_reduce(
            0, dst[:, None].expand(-1, k), s.detach(), "amax")
        e = torch.exp(s - m[dst])
        z = torch.zeros((n, k)).index_add(0, dst, e)
        u = ref_gat._WeightedSum.apply(e, h, src, dst, stage)
        if fault == "normaliser_left_out":
            return u
        return u / torch.clamp_min(z, ref_gat.Z_GUARD)[:, :, None]
    return attend


@pytest.mark.parametrize("fault", ["scores_in_bf16",
                                   "normaliser_left_out"])
def test_a_planted_fault_fails_the_tolerances(cfg, port_runs, fault,
                                              monkeypatch):
    monkeypatch.setattr(ref_gat, "attend", _faulty_attend(fault))
    seed = SEEDS[0]
    bad = _within(_gaps(port_runs[seed], _reference(cfg, seed)))
    assert "logits" in bad and "loss1" in bad, bad
    assert any(k.startswith("grad:") for k in bad), bad


def test_the_steps_run_the_attention_in_its_spans(cfg):
    """A traced step holds one ``gat_attend`` span a layer in its forward
    and one ``gat_attend_bwd`` a layer in its backward, with the layer's
    shape; a GCN step crosses neither."""
    was = obs.enabled()
    obs.get_tracer().clear()
    obs.enable(True)
    try:
        tr, (n, e) = train_run.build_trainer(cfg, SEEDS[1],
                                             torch.device("cpu"))
        tr.run_epoch()
        spans = obs.get_tracer().spans()
        gcn = copy.deepcopy(cfg)
        gcn.update(model="gcn", reference="gcn", layers=[24, 16, 5])
        obs.get_tracer().clear()
        train_run.build_trainer(gcn, SEEDS[1],
                                torch.device("cpu"))[0].run_epoch()
        gcn_names = {s.name for s in obs.get_tracer().spans()}
    finally:
        obs.enable(was)
        obs.get_tracer().clear()
    for name in ("gat_attend", "gat_attend_bwd"):
        got = sorted((s.args["heads"], s.args["head_dim"]) for s in spans
                     if s.name == name)
        assert got == [(1, 5), (8, 8)], (name, got)
        for s in spans:
            if s.name == name:
                assert (s.args["rows"], s.args["edges"],
                        s.args["precision"]) == (n, e, "fast")
    # the src kernel's lane group: 16 lanes of one 4-float pack at H = 64,
    # 8 lanes of one float at H = 5
    assert sorted((s.args["head_dim"], s.args["src_lanes"]) for s in spans
                  if s.name == "gat_attend_bwd") == [(5, 8), (8, 16)]
    assert not gcn_names & {"gat_attend", "gat_attend_bwd"}


@pytest.mark.parametrize("k,f,passes,head_loops", [
    (8, 8, 1, 0), (4, 64, 1, 0), (1, 41, 1, 0), (2, 3, 1, 0), (3, 5, 3, 1),
    (12, 5, 2, 0), (16, 4, 2, 0)])
def test_the_wrappers_count_sweeps_and_head_loops(k, f, passes, head_loops,
                                                  monkeypatch):
    """``gat_forward`` counts pass 1's sweeps (one each 4 heads: 2 at K =
    8) and ``gat_bwd_dst`` its passes over dq (one a group of up to 8
    heads: 1 at K = 8, 2 at 12 and 16, K at an odd K) and the launches
    that still sum a head at a time (an odd K above 1), beside their
    launches: the launch path, the shared ``CudaLibrary.launch`` included,
    run on meta tensors with the library's entry points, the device, the
    stream and the placement check stubbed out."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0
    monkeypatch.setattr(gat_k.LIBRARY, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(gat_k, "_require_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(gat_k, "gat_stage", lambda x: x)
    for counter in ("launches", "sweeps"):
        monkeypatch.setattr(gat_k.gat_forward, counter, 0)
    for counter in ("launches", "dq_passes", "head_loops"):
        monkeypatch.setattr(gat_k.gat_bwd_dst, counter, 0)
    meta = torch.device("meta")
    n, e = 6, 9
    row_ptr = torch.empty(n + 1, dtype=torch.int64, device=meta)
    col_idx = torch.empty(e, dtype=torch.int32, device=meta)
    x = torch.empty(n, k * f, device=meta)
    per_head = torch.empty(n, k, device=meta)
    gat_k.gat_forward(x, per_head, per_head, row_ptr, col_idx, 0.2, "fast")
    dq = torch.empty(e, k, device=meta)
    gat_k.gat_bwd_dst(dq, col_idx, row_ptr, col_idx)
    assert gat_k.gat_forward.launches == 1
    assert gat_k.gat_forward.sweeps == (k + 3) // 4
    assert gat_k.gat_bwd_dst.launches == 1
    assert gat_k.gat_bwd_dst.dq_passes == passes
    assert gat_k.gat_bwd_dst.head_loops == head_loops
    if k == 8:
        assert gat_k.gat_forward.sweeps == 2
        assert (gat_k.gat_bwd_dst.dq_passes,
                gat_k.gat_bwd_dst.head_loops) == (1, 0)


class _SrcLib:
    """The library's entry points stubbed: ``roc_gat_bwd_src`` records its
    (vec, lanes, packs) and refuses, as ``csrc/gat.cu:launch_src_group``
    does, a pair it does not build."""
    BUILT = ((8, 1), (16, 1), (32, 2))

    def __init__(self):
        self.src = []

    def __getattr__(self, name):
        return lambda *args: 0

    def roc_gat_bwd_src(self, *args):
        vec, lanes, packs = args[-5:-2]
        self.src.append((vec, lanes, packs))
        return 0 if (lanes, packs) in self.BUILT else 1   # InvalidValue


@pytest.mark.parametrize("k,f,pair,tiles", [
    (8, 8, (16, 1), 1), (4, 64, (32, 2), 1), (1, 41, (32, 2), 1),
    (2, 3, (8, 1), 1), (16, 4, (16, 1), 1), (2, 160, (32, 2), 2)])
def test_the_src_kernel_takes_the_forward_lane_group(k, f, pair, tiles,
                                                    monkeypatch):
    """``gat_bwd_src`` launches the src kernel in the lane group the
    forward's rule gives over the row's packs (the first pair of
    ``SRC_GROUPS`` whose lanes * packs cover them): 16 lanes of one 4-float
    pack at H = 64 and at 16 heads of 4, a warp of two at H = 256 and at
    layer 2's 41 one-float columns (``SRC_GROUPS`` leaves out the
    forward's (16, 3)), 8 lanes at 6, a warp over two 256-column tiles at
    H = 320.  ``gat_bwd_src.narrow_launches`` counts the launches under a
    warp.  A pair the library does not build, as the forward's (16, 3),
    raises, uncounted: the launch path run on meta tensors with the entry
    points, the device, the stream and the placement check stubbed out."""
    lib = _SrcLib()
    monkeypatch.setattr(gat_k.LIBRARY, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(gat_k, "_require_cuda", lambda *a, **kw: None)
    for counter in ("launches", "narrow_launches"):
        monkeypatch.setattr(gat_k.gat_bwd_src, counter, 0)
    meta = torch.device("meta")
    t, n, e = 5, 6, 9
    t_row_ptr = torch.empty(t + 1, dtype=torch.int64, device=meta)
    t_col_idx = torch.empty(e, dtype=torch.int32, device=meta)
    x = torch.empty(t, k * f, device=meta)
    as_ = torch.empty(t, k, device=meta)
    node = torch.empty(n, k, device=meta)
    du = torch.empty(n, k * f, device=meta)
    args = (x, as_, node, node, du, node, t_row_ptr, t_col_idx, 0.2, "fast")
    dtable, dast, dq = gat_k.gat_bwd_src(*args)
    assert (tuple(dtable.shape), tuple(dast.shape), tuple(dq.shape)) == (
        (t, k * f), (t, k), (e, k))
    vec = next(v for v in (4, 2, 1) if f % v == 0)
    assert lib.src == [(vec, *pair)]
    lanes, packs = pair
    assert -(-k * f // (lanes * packs * vec)) == tiles
    assert gat_k.gat_bwd_src.launches == 1
    assert gat_k.gat_bwd_src.narrow_launches == int(lanes < 32)
    assert gat_k.SRC_GROUPS == _SrcLib.BUILT
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        gat_k._src_launch(*args, gat_k.SrcGeometry(vec, 16, 3))
    assert (gat_k.gat_bwd_src.launches,
            gat_k.gat_bwd_src.narrow_launches) == (1, int(lanes < 32))


@pytest.mark.parametrize("k,groups", [
    (1, (1,)), (2, (2,)), (4, (4,)), (8, (8,)), (3, (1, 1, 1)),
    (5, (1,) * 5), (6, (4, 2)), (10, (8, 2)), (12, (8, 4)),
    (14, (8, 4, 2)), (16, (8, 8)), (40, (8,) * 5)])
def test_the_dst_kernel_reads_each_dq_row_in_few_passes(k, groups):
    """``dst_head_groups``, the dst kernel's pass plan: the whole row at K
    in {1, 2, 4, 8}, groups of 8, then 4, then 2 heads at any other even
    K, a head a pass at an odd K.  The groups cover the K heads once, and
    each starts and ends on the kernel's pack (4 floats where 4 divides K,
    else 2, else 1), so its loads stay aligned."""
    got = gat_k.dst_head_groups(k)
    assert got == groups
    assert sum(got) == k
    pack = next(w for w in (4, 2, 1) if k % w == 0)
    starts = [sum(got[:i]) for i in range(len(got))]
    assert all(c % pack == 0 and g % pack == 0 for c, g in zip(starts, got))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 6, 8, 10, 12, 14, 16])
def test_dst_kernel_sums_bitwise_as_one_head_launches(k):
    """On the card, ``gat_bwd_dst`` at K heads gives dadl bitwise equal to
    K launches at K = 1 on each column of dq: every pass plan sums each
    head in the K = 1 kernel's order (a lane over its edges in CSR order,
    then the same xor tree).  The K take every branch of the kernel's pass
    plan (``dst_head_groups``): a head a pass, 4 + 2, one group of 8,
    8 + 2, 8 + 4, 8 + 4 + 2, 8 + 8.  A random graph with a hub row of
    5,000 in-edges, an empty row and rows of under 32 edges; Gaussian dq,
    so a sum in another order shows in the bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2 ** 31 + k)
    deg = torch.randint(0, 32, (4000,), generator=gen)
    deg[0], deg[1], deg[2] = 5000, 0, 33
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                         deg.cumsum(0)]).to(dev)
    e = int(deg.sum())
    t_pos = torch.randperm(e, generator=gen).to(torch.int32).to(dev)
    col_idx = torch.zeros(e, dtype=torch.int32, device=dev)
    dq = torch.randn((e, k), generator=gen).to(dev)
    dadl = gat_k.gat_bwd_dst(dq, t_pos, row_ptr, col_idx)
    heads = torch.cat([gat_k.gat_bwd_dst(dq[:, j].contiguous().view(e, 1),
                                         t_pos, row_ptr, col_idx)
                       for j in range(k)], 1)
    torch.cuda.synchronize()
    assert torch.equal(dadl, heads)
    assert bool((dadl[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("k,f", [(8, 8), (4, 64), (1, 41), (3, 5), (16, 4),
                                 (2, 160)])
def test_src_kernel_lane_groups_bitwise_as_a_warp(k, f, precision):
    """On the card, ``gat_bwd_src`` in the rule's lane group and in every
    pair of ``SRC_GROUPS`` gives dtable, dast and dq bitwise equal to a
    launch at a warp of two packs, (32, 2), through the same entry point: each column's lane sums the row's edges in transposed order, dq
    adds its slots in column order (across tiles through dq where a head
    crosses one, as at H = 320 in a narrow group) and dast's 32 partials
    are indexed by the edge's position modulo 32.  A pair the library does
    not build, as the forward's (16, 3), raises.  A random graph with a hub row of 5,000 edges, an
    empty row and rows of under 32 edges; Gaussian du and x, so a sum in
    another order shows in the bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2 ** 31 + 100 * k + f)
    t = n = 4000
    deg = torch.randint(0, 32, (t,), generator=gen)
    deg[0], deg[1], deg[2] = 5000, 0, 33
    t_row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                           deg.cumsum(0)]).to(dev)
    e = int(deg.sum())
    t_col_idx = torch.randint(0, n, (e,), generator=gen,
                              dtype=torch.int32).to(dev)
    x, du = (torch.randn((r, k * f), generator=gen).to(dev) for r in (t, n))
    as_ = torch.randn((t, k), generator=gen).to(dev)
    ad, dz = (torch.randn((n, k), generator=gen).to(dev) for _ in range(2))
    m = torch.randn((n, k), generator=gen).abs().to(dev)
    args = (x, as_, ad, m, du, dz, t_row_ptr, t_col_idx, 0.2, precision)
    geo = gat_k.src_geometry(k, f, x, du)
    want = gat_k._src_launch(*args, gat_k.SrcGeometry(geo.vec, 32, 2))
    got = {pair: gat_k._src_launch(*args, gat_k.SrcGeometry(geo.vec, *pair))
           for pair in gat_k.SRC_GROUPS}
    rule = gat_k.gat_bwd_src(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dtable", "dast", "dq"), rule, want):
        assert torch.equal(a, b), (geo, name)
    for pair, out in got.items():
        for name, a, b in zip(("dtable", "dast", "dq"), out, want):
            assert torch.equal(a, b), (pair, name)
    assert bool((rule[0][1] == 0).all()) and bool((rule[1][1] == 0).all())
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        gat_k._src_launch(*args, gat_k.SrcGeometry(geo.vec, 16, 3))
