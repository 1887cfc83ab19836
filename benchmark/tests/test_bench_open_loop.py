"""The open loop times each request from when it was due: a stall delays
the requests behind it, and their latency counts the wait."""

from __future__ import annotations

import numpy as np

from benchmark.harness import serve


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_latency_counts_from_due_time():
    clock = FakeClock()
    service = {0: 1e-3, 1: 50e-3, 2: 1e-3, 3: 1e-3, 4: 1e-3}  # request 1 stalls 50 ms

    answered = []

    def answer(j, user):
        clock.t += service[user]
        answered.append((j, user))

    def wait(dt):
        clock.t += dt

    due = np.array([0.0, 0.010, 0.020, 0.030, 0.100])
    lat, late, took = serve.open_loop(answer, due, np.arange(5), clock=clock, wait=wait)
    assert answered == [(j, j) for j in range(5)]
    np.testing.assert_allclose(took, [1e-3, 50e-3, 1e-3, 1e-3, 1e-3])
    # request 1 starts on time and ends at 60 ms; 2 and 3 were due at 20 and
    # 30 ms and start behind it; 4 is due after the queue has drained
    np.testing.assert_allclose(late, [0.0, 0.0, 0.040, 0.031, 0.0], atol=1e-12)
    np.testing.assert_allclose(lat, [1e-3, 50e-3, 41e-3, 32e-3, 1e-3], atol=1e-12)


def test_schedule_same_arrivals_for_every_seed():
    traffic = {"rate_per_s": 1000, "arrival_seed": 0, "zipf_s": 1.0}
    due_a, users_a = serve.schedule(traffic, 2.0, 1, 500)
    due_b, users_b = serve.schedule(traffic, 2.0, 2**33 + 5, 500)
    np.testing.assert_array_equal(due_a, due_b)
    assert len(due_a) == 2000 and due_a[0] == 0.0 and due_a[-1] < 2.0
    assert not np.array_equal(users_a, users_b)
    assert users_a.min() >= 0 and users_a.max() < 500


def test_percentile_nearest_rank_below():
    assert serve.percentile(list(range(1, 101)), 0.95) == 96
    assert serve.percentile([3.0], 0.95) == 3.0
