"""Mean of the port's ``serve_window`` spans in the window (the engine's
obs tracer, on in the traced run), in ms."""


def read(run):
    if run["kind"] != "serve" or not run["window_spans_ms"]:
        return None
    return sum(run["window_spans_ms"]) / len(run["window_spans_ms"])
