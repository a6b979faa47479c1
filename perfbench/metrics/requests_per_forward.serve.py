"""Queries answered over ``ServeEngine.forwards`` in the window: how many
requests one full-graph forward serves."""


def read(run):
    if run["kind"] != "serve" or not run["forwards"]:
        return None
    return run["answered"] / run["forwards"]
