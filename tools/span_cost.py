"""Per-span cost of the port's host tracer (``roc_tpu_torch/obs/tracer.py``).

    python tools/span_cost.py [--root DIR ...] [--n N] [--out FILE]

For each ``--root`` (a checkout; default: this one) the tracer module is
loaded from that tree by path, so two versions are timed in one process,
and each of these is timed as the best of five loops of ``--n`` spans:

  disabled   ``with tracer.span("x"): pass`` with the ring off and no
             profiler recording
  enabled    the same with the ring on
  profiled   the same with the ring off under a CPU ``torch.profiler``
             session (where the tracer mirrors its spans into the
             profiler, the mirror's cost is in it)

``record_function`` alone under the same session is printed beside them.
One JSON object a root goes to standard output (and to ``--out``), in ns
a span.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import timeit

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tracer(root: str, tag: str):
    path = os.path.join(root, "roc_tpu_torch", "obs", "tracer.py")
    spec = importlib.util.spec_from_file_location(f"_tracer_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_call_ns(fn, n: int, repeats: int = 5) -> float:
    """Best of ``repeats`` timings of ``fn(n)``, collector on (as in a
    run), in ns a call."""
    return min(timeit.repeat(lambda: fn(n), setup=gc.enable, number=1,
                             repeat=repeats)) * 1e9 / n


def span_loop(tracer):
    def run(n):
        for _ in range(n):
            with tracer.span("x"):
                pass
    return run


def measure(root: str, tag: str, n: int) -> dict:
    import torch
    mod = load_tracer(root, tag)
    off = mod.SpanTracer(capacity=1024)
    on = mod.SpanTracer(capacity=1024)
    on.enabled = True
    out = {"root": root,
           "disabled_ns": per_call_ns(span_loop(off), n),
           "enabled_ns": per_call_ns(span_loop(on), n)}
    n_prof = max(n // 10, 1)

    def rf_loop(k):
        for _ in range(k):
            with torch.profiler.record_function("x"):
                pass
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        out["profiled_ns"] = per_call_ns(span_loop(off), n_prof)
        out["record_function_ns"] = per_call_ns(rf_loop, n_prof)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="span_cost")
    p.add_argument("--root", action="append", default=None)
    p.add_argument("--n", type=int, default=200000)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    lines = []
    for i, root in enumerate(a.root or [HERE]):
        line = json.dumps(measure(os.path.abspath(root), str(i), a.n))
        print(line)
        lines.append(line)
    if a.out:
        with open(a.out, "a", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
