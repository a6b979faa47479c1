"""Due-time accounting of the open-loop offer, against a fake engine
that stalls, on a fake clock."""

import math

import pytest

from perfbench import inputs, loadgen


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class Done:
    def __init__(self, t_done):
        self.t_done = t_done

    def result(self, timeout=None):
        return None


class StalledEngine:
    """Answers each request 5 ms after it is submitted, except that the
    request submitted at or after ``stall_at`` blocks the submitting call
    for ``stall`` seconds, as a queue that stops taking requests does."""

    def __init__(self, clock, stall_at, stall):
        self.clock, self.stall_at, self.stall = clock, stall_at, stall
        self.stalled = False

    def submit(self, ids):
        if not self.stalled and self.clock() >= self.stall_at:
            self.stalled = True
            self.clock.sleep(self.stall)
        return Done(self.clock() + 0.005)


def test_a_stall_is_charged_to_every_request_due_behind_it():
    clock = Clock()
    eng = StalledEngine(clock, stall_at=100.1, stall=0.3)
    sched = [(i * 0.01, [i]) for i in range(100)]       # 100 qps for 1 s
    offers = loadgen.offer(sched, eng.submit, 100.0, clock=clock,
                           sleep=clock.sleep)
    lat = [loadgen.latency_s(o, "t_done") for o in offers]
    # before the stall every request takes its 5 ms
    assert lat[:10] == pytest.approx([0.005] * 10)
    # the request that stalls, and those due while it stalled, are timed
    # from when they were due, not from when they were finally sent
    assert lat[10] == pytest.approx(0.305)
    assert lat[11] == pytest.approx(0.295)
    assert lat[39] == pytest.approx(0.015)
    assert lat[40] == pytest.approx(0.005)
    assert offers[11].late_s == pytest.approx(0.29)
    assert loadgen.percentile(lat, 0.95) > 0.2


def test_failures_count_as_missing_every_limit():
    clock = Clock()

    def refuse(ids):
        raise RuntimeError("shed")
    offers = loadgen.offer([(0.0, [1]), (0.01, [2])], refuse, 100.0,
                           clock=clock, sleep=clock.sleep)
    assert all(o.error is not None for o in offers)
    assert all(math.isinf(loadgen.latency_s(o, "t_done")) for o in offers)
    assert math.isinf(loadgen.percentile(
        [0.001] * 90 + [math.inf] * 10, 0.95))


def test_a_blocking_call_is_timed_to_its_return():
    clock = Clock()

    def apply(batch):
        clock.sleep(0.25)
    offers = loadgen.offer([(0.0, 1), (0.1, 2)], apply, 100.0, clock=clock,
                           sleep=clock.sleep)
    assert [loadgen.latency_s(o) for o in offers] == pytest.approx(
        [0.25, 0.40])


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert loadgen.percentile(vals, 0.95) == 95
    assert loadgen.percentile(vals, 0.5) == 50
    assert loadgen.percentile([3.0], 0.95) == 3.0


def test_every_seed_offers_the_same_gaps_and_sizes():
    traffic = {"qps": 500, "sizes": [1, 2, 3, 5, 8, 13]}
    a = inputs.query_schedule(traffic, 1, 22, 2.0, 1000)
    b = inputs.query_schedule(traffic, 2 ** 31 + 9, 22, 2.0, 1000)
    assert len(a) == len(b) == 1000
    assert [t for t, _ in a] != [t for t, _ in b]

    def gaps(s):
        due = [t for t, _ in s] + [2.0]
        return sorted(round(y - x, 12) for x, y in zip(due, due[1:]))
    assert gaps(a) == gaps(b)
    assert sorted(len(i) for _, i in a) == sorted(len(i) for _, i in b)
    assert all(0 <= t < 2.0 for t, _ in a + b)
    assert all(0 <= int(i.min()) and int(i.max()) < 1000 for _, i in a)
