"""CLI: ``python -m roc_tpu_torch.obs report|calibration|selftest``
(roc_tpu/obs/__main__.py).

report      text summary of a -obs run's trace.json + metrics.jsonl
calibration join a run's prediction/measurement ledger records and report
            per-cost-model calibration error; --selftest runs the gate
            (tiny runs of the port's producers must pair >= 5 models
            inside their sanity bands; on the card unless -device cpu)
selftest    the obs gate (tracer schema, watchdog fire/quiet, span
            overhead bound); exit 0 green, 1 red
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="roc_tpu_torch.obs", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="summarize a -obs run's artifacts")
    rp.add_argument("-dir", dest="obs_dir", default="roc_obs",
                    help="obs output dir (default: roc_obs)")
    rp.add_argument("-trace", default="", help="trace.json path override")
    rp.add_argument("-metrics", default="", help="metrics.jsonl override")
    cp = sub.add_parser("calibration",
                        help="per-cost-model predicted-vs-measured report")
    cp.add_argument("-dir", dest="obs_dir", default="roc_obs",
                    help="obs output dir (default: roc_obs)")
    cp.add_argument("-metrics", default="", help="metrics.jsonl override")
    cp.add_argument("--selftest", action="store_true",
                    help="gate: tiny runs must pair >= 5 cost models "
                         "inside their sanity bands")
    cp.add_argument("-device", "--device", dest="device", default="cuda",
                    help="device of the --selftest runs (default: cuda)")
    sub.add_parser("selftest", help="obs gate: schema + watchdog + overhead")
    ns = p.parse_args(argv)

    if ns.cmd == "selftest":
        from roc_tpu_torch.obs.report import selftest
        return selftest()

    if ns.cmd == "calibration":
        from roc_tpu_torch.obs.report import calibration, calibration_selftest
        if ns.selftest:
            return calibration_selftest(ns.device)
        return calibration(ns.metrics
                           or os.path.join(ns.obs_dir, "metrics.jsonl"))

    from roc_tpu_torch.obs.report import report
    trace = ns.trace or os.path.join(ns.obs_dir, "trace.json")
    metrics = ns.metrics or os.path.join(ns.obs_dir, "metrics.jsonl")
    print(report(trace_path=trace if os.path.exists(trace) else "",
                 metrics_path=metrics if os.path.exists(metrics) else ""))
    if not (os.path.exists(trace) or os.path.exists(metrics)):
        print(f"# no artifacts under {ns.obs_dir!r} "
              "(run with -obs / ROC_OBS=1 first)", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
