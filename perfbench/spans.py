"""The port's host spans in a traced serve run: ``perfbench/serve_run.py``
clears the ring of ``roc_tpu_torch.obs`` at the window's start, turns it
on for the traced window alone and off after it, so when the readers run
the ring holds the window's spans (and those closed while the device trace
was being read, which the readers clip away where it matters)."""


def named(run, name: str) -> list:
    """The ring's spans called ``name`` in a serve run, in the order they
    closed ([] in any other run, or where the program records none)."""
    if run["kind"] != "serve":
        return []
    from roc_tpu_torch import obs
    return [s for s in obs.get_tracer().spans() if s.name == name]
