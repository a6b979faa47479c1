"""The longest pause of Python's garbage collector inside the window, in
ms (``gc.callbacks`` on the host clock, set-up's objects frozen): every
thread of the server stands still in it, and every query due in it
waits."""


def read(run):
    if run["kind"] != "serve" or not run.get("gc_pauses_ms"):
        return None
    return max(run["gc_pauses_ms"])
