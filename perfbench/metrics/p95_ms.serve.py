"""The 95th percentile over all queries of the window of the time from
when each was due to when its logits resolved, in ms (nearest rank; a
failed query counts as infinite)."""


def read(run):
    if run["kind"] != "serve" or "p95_ms" not in run:
        return None
    return run["p95_ms"]
