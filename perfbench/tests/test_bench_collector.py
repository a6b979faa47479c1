"""The serve window's garbage collection: set-up's objects frozen for the
window and unfrozen after it, the window's own collections still run and,
when watched, each pause is kept for ``gc_pause_ms.serve``."""

import gc

from perfbench import spec
from perfbench.serve_run import Collector


def test_setup_objects_frozen_for_the_window_only():
    made_in_setup = [[i] for i in range(1000)]
    with Collector(False):
        assert gc.get_freeze_count() >= len(made_in_setup)
    assert gc.get_freeze_count() == 0


def test_window_collections_run_and_are_timed():
    callbacks = list(gc.callbacks)
    with Collector(True) as coll:
        made_in_window = [[i] for i in range(1000)]
        gc.collect()
    assert made_in_window and coll.pauses_ms
    assert all(p >= 0 for p in coll.pauses_ms)
    assert gc.callbacks == callbacks
    read = spec.metric_reader("gc_pause_ms.serve")
    assert read({"kind": "serve", "gc_pauses_ms": coll.pauses_ms}) == \
        max(coll.pauses_ms)


def test_unwatched_window_reports_nothing():
    with Collector(False) as coll:
        gc.collect()
    assert coll.pauses_ms == []
    assert spec.metric_reader("gc_pause_ms.serve")(
        {"kind": "serve", "gc_pauses_ms": []}) is None


def test_p95_reader():
    read = spec.metric_reader("p95_ms.serve")
    assert read({"kind": "serve", "p95_ms": 18.5}) == 18.5
    assert read({"kind": "train"}) is None
