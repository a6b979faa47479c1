"""CLI for the launch autotuner (roc_tpu/tune/__main__.py's flags and
output lines).

    python -m roc_tpu_torch.tune                  # CI surrogate sweep,
                                                  # write the tuned store
    python -m roc_tpu_torch.tune --refit          # + the refit rates
    python -m roc_tpu_torch.tune --selftest       # the gate: a seeded
        sweep run TWICE end to end (byte-identical stores), schema
        validation, a DeviceCsr placement consuming the tuned entry, an
        off-key graph on the default rule, refit within 5 % of the
        generating rates, the ledger pairing each model; on the CPU.
    python -m roc_tpu_torch.tune --device --refit --update   # on the
        card: Reddit's CSR and its transpose timed with CUDA events, the
        store beside the plan cache, the refit rates written to the
        port's measured table (refit.measured_path) with the card's name
        and power limit.

The surrogate sweep never writes the measured table; its store is read by
placements on any device (a launch choice, not a rate, and no launch
changes a bit).  ``ROC_TUNE_OBS_DIR`` (default ``roc_obs_tune``) holds the
sweep's ledger records.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _attach_ledger(obs_dir: str):
    from roc_tpu_torch import obs
    os.makedirs(obs_dir, exist_ok=True)
    reg = obs.MetricsRegistry(
        jsonl_path=os.path.join(obs_dir, "metrics.jsonl"))
    led = obs.get_ledger()
    led.attach(reg.emit)
    return led


def _report(led) -> dict:
    from roc_tpu_torch.obs.ledger import calibration_report
    return calibration_report([{"type": k, **r} for k, r in led.records])


def _shapes(args):
    from roc_tpu_torch.tune import search
    if args.shapes == "device":
        return search.reddit_shapes(args.seed)
    return search.SHAPES_CI


def _run_sweep(args, path: str, shapes, log=print):
    from roc_tpu_torch.tune import refit as R
    from roc_tpu_torch.tune import search, store
    entries, trials = search.sweep(
        shapes, storage_dtype=args.storage, fuse_linear=args.fuse,
        seed=args.seed, device=args.device, screen_keep=args.screen_keep,
        final_keep=args.final_keep, log=log)
    doc = store.merge_entries(path, entries, interpret=not args.device,
                              seed=args.seed)
    return doc, trials, R.refit_rates(trials)


def _selftest(args) -> int:
    """The determinism and consumption gate, in a temporary directory; the
    process environment is restored."""
    import torch

    from roc_tpu_torch.graph.csr import from_edges
    from roc_tpu_torch.obs.ledger import get_ledger
    from roc_tpu_torch.ops import DeviceCsr
    from roc_tpu_torch.tune import search, store
    from roc_tpu_torch.tune.lattice import default_config
    ok = True

    def check(name, cond, detail=""):
        nonlocal ok
        print(f"tune-selftest: {name}: "
              f"{'ok' if cond else 'FAIL'}{' ' + detail if detail else ''}")
        ok = ok and bool(cond)

    with tempfile.TemporaryDirectory(prefix="roc_tune_selftest_") as td:
        led = _attach_ledger(os.path.join(td, "obs"))
        env0 = {k: os.environ.get(k)
                for k in ("ROC_TUNED_PATH", "ROC_NO_TUNED")}
        try:
            paths = [os.path.join(td, f"tuned_{i}.json") for i in (0, 1)]
            docs = []
            for p in paths:
                doc, trials, rates = _run_sweep(args, p, search.SHAPES_CI,
                                                log=lambda *_: None)
                docs.append(doc)
            blobs = [open(p, "rb").read() for p in paths]
            check("byte-identical across two runs", blobs[0] == blobs[1],
                  f"({len(blobs[0])} bytes)")
            check("schema valid", not store.validate_store(docs[0]),
                  f"({len(docs[0]['entries'])} entries)")

            # consumption: a placement of the swept graph carries the
            # tuned launches, an off-key graph the default rule
            shape = search.synth_shape(*search.SHAPES_CI[0])
            os.environ["ROC_TUNED_PATH"] = paths[0]
            os.environ.pop("ROC_NO_TUNED", None)
            store.clear_cache()
            vkey = store.variant_key(args.storage, args.fuse)
            want = {k: tuple(e["launch"]) for k, e in docs[0]["entries"][
                store.graph_key(shape.edge_src, shape.edge_dst,
                                shape.num_rows, shape.table_rows)][vkey]
                .items()}
            table = store.launch_table(shape.edge_src, shape.edge_dst,
                                       shape.num_rows, shape.table_rows,
                                       args.storage, args.fuse)
            csr = DeviceCsr.from_csr(
                from_edges(shape.num_rows, shape.edge_src, shape.edge_dst),
                torch.device("cpu"), launch=table)
            prec = store.precision_of(args.storage)
            got = {k: csr.sum_launch(False, int(k[4:]), prec)
                   for k in want if k.startswith("sum/")}
            check("DeviceCsr.launch consumes tuned entry",
                  table is not None and got == {
                      k: v for k, v in want.items() if k.startswith("sum/")},
                  f"({len(want)} kernels, {got})")
            other = search.synth_shape("other", 2048, 4096, 7)
            off = store.launch_table(other.edge_src, other.edge_dst,
                                     other.num_rows, other.table_rows,
                                     args.storage, args.fuse)
            base = default_config("sum", (256,), prec)
            check("default rule off-key", off is None,
                  f"(default {base.label})")

            bad = {k: r for k, r in rates["vs_constants"].items()
                   if abs(r - 1.0) > 0.05}
            check("refit within 5% of generating constants",
                  not bad and len(rates["vs_constants"]) == 2,
                  "(" + ", ".join(f"{k}={v:.4f}" for k, v in sorted(
                      rates["vs_constants"].items())) + ")")

            rep = _report(led)
            for model in ("tune_trial", "tune_confirm", "tune_probe"):
                m = rep["models"].get(model)
                check(f"ledger pairs {model}",
                      m is not None and m["pairs"] > 0
                      and 0.9 <= m["ratio_mean"] <= 1.1,
                      f"({m['pairs']} pairs, mean "
                      f"{m['ratio_mean']:.3f})" if m else "")
        finally:
            for k, v in env0.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            store.clear_cache()
            led.detach()
            get_ledger().clear()
    print(f"tune-selftest: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m roc_tpu_torch.tune",
                                description=__doc__.splitlines()[0])
    p.add_argument("--selftest", action="store_true",
                   help="seeded end-to-end sweep gate on the CPU")
    p.add_argument("--shapes", choices=("ci", "device"), default=None,
                   help="sweep shape set (default: ci; device, Reddit's "
                        "CSR and its transpose, with --device)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="",
                   help="tuned store path (default: beside the plan "
                        "cache / ROC_TUNED_PATH)")
    p.add_argument("--device", action="store_true",
                   help="time the kernels on the card (CUDA only)")
    p.add_argument("--storage", choices=("fp32", "bf16"), default="bf16",
                   help="the variant: bf16 is fast (the default), fp32 "
                        "exact")
    p.add_argument("--fuse", action="store_true",
                   help="tune the -megafuse variant")
    p.add_argument("--refit", action="store_true",
                   help="re-solve the launch model's rates from the trials")
    p.add_argument("--update", action="store_true",
                   help="with --refit on the card: write the port's "
                        "measured table")
    p.add_argument("--screen-keep", type=int, default=16)
    p.add_argument("--final-keep", type=int, default=4)
    args = p.parse_args(argv)
    if args.shapes is None:
        args.shapes = "device" if args.device else "ci"

    if args.selftest:
        return _selftest(args)

    import torch
    if args.device and not torch.cuda.is_available():
        print("tune: --device but no CUDA device is available; refusing to "
              "record CPU timings", file=sys.stderr)
        return 1

    from roc_tpu_torch.tune import refit as R
    from roc_tpu_torch.tune import store
    path = args.out or store.tuned_store_path()
    if not path:
        print("tune: tuned store disabled (ROC_NO_TUNED/ROC_PLAN_CACHE=0) "
              "and no --out given", file=sys.stderr)
        return 1
    led = _attach_ledger(os.environ.get("ROC_TUNE_OBS_DIR", "roc_obs_tune"))
    try:
        doc, trials, rates = _run_sweep(args, path, _shapes(args))
    finally:
        led.detach()
    print(f"tune: wrote {len(doc['entries'])} graph entries -> {path}")
    rep = _report(led)
    for model in sorted(rep["models"]):
        m = rep["models"][model]
        print(f"# calibration {model}: {m['pairs']} pairs, mean ratio "
              f"{m['ratio_mean']:.3g}")
    if args.refit:
        print("tune: refit rates " + json.dumps(
            {k: rates[k] for k in ("byte_s", "row_s")}, sort_keys=True))
        print("tune: refit vs generating constants " + json.dumps(
            {k: round(v, 4) for k, v in sorted(
                rates["vs_constants"].items())}))
        if args.update:
            name, limit = R.card_identity()
            table = R.to_measured_table(trials, interpret=not args.device,
                                        name=name, power_limit=limit)
            out = R.update(table)
            print(f"tune: wrote the measured table ({name}, {limit}) -> "
                  f"{out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
