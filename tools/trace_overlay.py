"""Do a run's ``-obs`` trace and its ``-profile`` trace overlay?

    python tools/trace_overlay.py OBS_TRACE PROFILE_TRACE [--span epoch]

For each ``--span`` span of the ``-obs`` trace (``<obs_dir>/trace.json``,
the port's span ring) that starts inside the ``-profile`` trace
(``<profile_dir>/trace.json``, torch.profiler's export), prints, in
microseconds from its start on the profiler's clock: the start of the same
span mirrored into the profiler (the ``user_annotation`` of that name on
the same thread, nearest), and the first operator (``cpu_op``) and the
first kernel launch (``cudaLaunchKernel``) on its thread at or after it.
The traces overlay when every mirror lies within 1 ms; the launches within
1 ms are counted beside (what runs on the host before a span's first
launch is the program's own work, which the trace shows).  Exits 1 when a
mirror lies 1 ms or more away, or when no span is compared.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
LIMIT_US = 1000.0


def load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def compare(obs: dict, prof: dict, name: str) -> list:
    """One row a compared span: (ts, mirror - ts, first operator - ts,
    first launch - ts), in microseconds (None where there is none)."""
    shift = (obs.get("baseTimeNanoseconds", 0)
             - prof.get("baseTimeNanoseconds", 0)) / 1e3
    events = [e for e in prof["traceEvents"] if e.get("ph") == "X"]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e.get("dur", 0) for e in events)
    mirrors, ops, launches = {}, {}, {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] == name:
            mirrors.setdefault(e["tid"], []).append(e["ts"])
        elif e.get("cat") == "cpu_op":
            ops.setdefault(e["tid"], []).append(e["ts"])
        elif e["name"] in LAUNCHES:
            launches.setdefault(e["tid"], []).append(e["ts"])
    for table in (mirrors, ops, launches):
        for v in table.values():
            v.sort()
    rows = []
    for s in obs["traceEvents"]:
        ts = s["ts"] + shift
        if s["name"] != name or not lo <= ts <= hi:
            continue
        rows.append((ts, _nearest(mirrors.get(s["tid"], []), ts),
                     _next(ops.get(s["tid"], []), ts),
                     _next(launches.get(s["tid"], []), ts)))
    return rows


def _nearest(times: list, ts: float):
    if not times:
        return None
    i = bisect.bisect_left(times, ts)
    near = [times[j] for j in (i - 1, i) if 0 <= j < len(times)]
    return min(near, key=lambda t: abs(t - ts)) - ts


def _next(times: list, ts: float):
    i = bisect.bisect_left(times, ts)
    return times[i] - ts if i < len(times) else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace_overlay")
    p.add_argument("obs_trace")
    p.add_argument("profile_trace")
    p.add_argument("--span", default="epoch")
    a = p.parse_args(argv)
    rows = compare(load(a.obs_trace), load(a.profile_trace), a.span)
    print(f"{'ts_us':>20} {'mirror_us':>10} {'first_op_us':>11} "
          f"{'launch_us':>10}")
    near = launched = 0
    for ts, mirror, op, launch in rows:
        near += mirror is not None and abs(mirror) < LIMIT_US
        launched += launch is not None and 0 <= launch < LIMIT_US
        print(f"{ts:20.3f} {_fmt(mirror):>10} {_fmt(op):>11} "
              f"{_fmt(launch):>10}")
    ok = bool(rows) and near == len(rows)
    print(f"{len(rows)} {a.span} span(s): {near} mirrored within "
          f"{LIMIT_US:g} us, {launched} with a kernel launched within it: "
          f"the traces {'overlay' if ok else 'do NOT overlay'}")
    return 0 if ok else 1


def _fmt(v):
    return "none" if v is None else f"{v:.3f}"


if __name__ == "__main__":
    sys.exit(main())
