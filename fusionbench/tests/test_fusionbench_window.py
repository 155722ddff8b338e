"""The window's arithmetic: a scheduled stall of known length gives the
known ``frame_ms_p95`` and count of frames not completed, and the
completion thread records every frame."""

import threading
import time

import pytest

from fusionbench import window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class Handle:
    def __init__(self, done_at):
        self.done_at = done_at


class Recorded:
    """Completions whose times are the handles' own (a modelled device)."""

    def __init__(self):
        self.times = {}

    def add(self, k, h):
        if h.done_at is not None:
            self.times[k] = h.done_at


def test_open_loop_stall_gives_known_p95():
    # 100 frames at 30 Hz, each done the moment it is offered, except frame
    # 40, whose call holds the host for 200 ms: frames 41-45 are offered
    # late, at once, 166.7 .. 33.3 ms after they were due
    clk, comp = Clock(), Recorded()
    stall = 0.200

    def offer(k):
        if k == 40:
            clk.t += stall
        return Handle(clk.t)

    res = window.open_loop(offer, 100, 30.0, comp, clock=clk, sleep=clk.sleep)
    m = window.live_metrics(res["due"], comp.times)
    lat = sorted(m["latency_ms"])
    assert lat[-6:] == pytest.approx([200 / 6 * j for j in range(1, 7)])
    assert m["frame_ms_p50"] == pytest.approx(0.0)
    # 94 zeros, then 33.3 .. 200: the 95th percentile lies 5 % of the way
    # from the 95th value to the 96th
    assert m["frame_ms_p95"] == pytest.approx(1000 / 30 * 1.05)
    assert m["not_completed"] == 0


def test_open_loop_lost_frames_count_as_not_completed():
    clk, comp = Clock(), Recorded()
    res = window.open_loop(lambda k: Handle(None if k in (3, 7) else clk.t), 10, 30.0, comp,
                           clock=clk, sleep=clk.sleep)
    m = window.live_metrics(res["due"], comp.times)
    assert m["not_completed"] == 2 and m["completed"] == 8


def test_closed_loop_frames_in_flight_at_the_end_are_not_completed():
    # each call takes 10 ms of host time and its frame completes 50 ms after
    # the call returns: of the 100 frames offered in 1 s, the last 6 finish
    # after the window's end
    clk, comp = Clock(), Recorded()

    def offer(k):
        clk.t += 0.010
        return Handle(clk.t + 0.050)

    res = window.closed_loop(offer, 1.0, comp, clock=clk)
    m = window.offline_metrics(res["t0"], res["t_end"], len(res["spans"]), comp.times)
    assert len(res["spans"]) == 100
    assert m["completed"] == 94 and m["not_completed"] == 6
    assert m["fps"] == pytest.approx(94.0)


def test_completion_thread_waits_in_order():
    release = [threading.Event() for _ in range(3)]

    class H:
        def __init__(self, i):
            self.i = i

        def synchronize(self):
            assert release[self.i].wait(5)

    c = window.Completions()
    for i in range(3):
        c.add(i, H(i))
    for e in release:
        time.sleep(0.01)
        e.set()
    done = c.close(5)
    assert sorted(done) == [0, 1, 2]
    assert done[0] <= done[1] <= done[2]


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert window.percentile(xs, 50) == 3.0
    assert window.percentile(xs, 95) == pytest.approx(4.8)
    assert window.percentile(xs, 0) == 1.0
