"""Share of the traced window in which the queue's worker was blocked with
nothing pending: the ``queue_idle`` spans, clipped to the served stretch
(the first request's submit to the last window's resolve), over the device
trace's ``window_s``, in %."""

from perfbench import spans


def read(run):
    idle = spans.named(run, "queue_idle")
    queued = spans.named(run, "request_queued")
    resolved = spans.named(run, "queue_resolve")
    if not idle or not queued or not resolved or not run["trace"]:
        return None
    lo = min(s.start_ns for s in queued)
    hi = max(s.start_ns + s.dur_ns for s in resolved)
    ns = sum(max(0, min(s.start_ns + s.dur_ns, hi) - max(s.start_ns, lo))
             for s in idle)
    return 100.0 * ns / 1e9 / run["trace"]["window_s"]
