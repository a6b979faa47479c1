"""Share of the traced window in which no operation ran on the device
(torch.profiler), in %."""


def read(run):
    if run["kind"] != "serve" or not run["trace"]:
        return None
    tr = run["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
