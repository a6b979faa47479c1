"""Mean of ``late_us`` over the window's ``queue_fill`` spans that carry
it: how far past the batching deadline the queue's worker woke, where a
window drained because its wait ran out (the interpreter lock held by
another thread, a collector's pass), in ms."""

from perfbench import spans


def read(run):
    late = [s.args["late_us"] for s in spans.named(run, "queue_fill")
            if s.args and "late_us" in s.args]
    return sum(late) / len(late) / 1e3 if late else None
