"""The measured window: how frames are offered, when each completes, and the
arithmetic of the end-to-end metrics.

Frozen here so that a later change to the program cannot move the yardstick:
the helpers come from the port's ``scripts/common.py`` (``reset_peak``,
``peak_bytes``, ``gpu_line``; ``drive``'s protocol of
untimed frames, then a window that ends in one wait for the device).

- Open loop (a live sensor): frame ``k`` is due at ``t0 + k / rate``; the
  loop sleeps until it is due, or offers it at once when it is late. Its
  latency runs from when it was due to when it completed.
- Closed loop (a recorded scan): each frame is offered as soon as the
  previous call returns, until the window's seconds have passed.

A frame completes when the device has finished its pose, fusion and render:
``System.process`` records an event after ``process_frame`` returns, and a
thread of the benchmark's own waits on the events in order and takes the
host clock as each one completes.
"""

from __future__ import annotations

import queue
import subprocess
import threading
import time

import torch


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device):
    """Peak device memory allocated since the last ``reset_peak``; None off
    the card (not measured)."""
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else None


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Completions:
    """Completion times of offered frames, taken on a thread of their own:
    it waits on each frame's handle in order (``synchronize()``) and reads
    the clock when it returns."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.times = {}
        self._q = queue.Queue()
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            k, handle = item
            try:
                handle.synchronize()
            except Exception as e:  # recorded, and raised by close()
                self._error = e
                return
            self.times[k] = self.clock()

    def add(self, k: int, handle) -> None:
        self._q.put((k, handle))

    def close(self, timeout: float) -> dict:
        """Wait up to ``timeout`` seconds for every frame added; returns
        {frame: completion time} of those that completed."""
        self._q.put(None)
        self._thread.join(timeout)
        if self._error is not None:
            raise self._error
        return dict(self.times)


def open_loop(offer, n: int, rate_hz: float, completions: Completions, clock=time.perf_counter,
              sleep=time.sleep, on_frame=None) -> dict:
    """Offer frames ``0 .. n-1`` at ``rate_hz``: ``offer(k)`` returns the
    frame's completion handle. ``on_frame(k)``, when given, runs before
    frame ``k`` is offered. Returns the due times, the host spans of each
    offer and the schedule's start."""
    t0 = clock()
    due = [t0 + k / rate_hz for k in range(n)]
    spans = []
    for k in range(n):
        if on_frame is not None:
            on_frame(k)
        now = clock()
        if now < due[k]:
            sleep(due[k] - now)
        start = clock()
        completions.add(k, offer(k))
        spans.append((start, clock()))
    return {"t0": t0, "due": due, "spans": spans}


def closed_loop(offer, seconds: float, completions: Completions, clock=time.perf_counter,
                on_frame=None) -> dict:
    """Offer frames one after another for ``seconds``. Returns the window's
    start and end and the host spans of each offer."""
    t0 = clock()
    t_end = t0 + seconds
    spans = []
    k = 0
    while clock() < t_end:
        if on_frame is not None:
            on_frame(k)
        start = clock()
        completions.add(k, offer(k))
        spans.append((start, clock()))
        k += 1
    return {"t0": t0, "t_end": t_end, "spans": spans}


def percentile(xs, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``xs``, linear between closest
    ranks (numpy's default)."""
    s = sorted(xs)
    if not s:
        return float("nan")
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def live_metrics(due, done: dict) -> dict:
    """Latency of every frame of an open-loop window, from when it was due
    to when it completed: its median and 95th percentile in ms over all
    frames that completed, and the frames that never did."""
    lat = [1e3 * (done[k] - d) for k, d in enumerate(due) if k in done]
    return {"frame_ms_p50": percentile(lat, 50), "frame_ms_p95": percentile(lat, 95),
            "completed": len(lat), "not_completed": len(due) - len(lat),
            "latency_ms": lat}


def offline_metrics(t0: float, t_end: float, offered: int, done: dict) -> dict:
    """Frames per second of a closed-loop window: frames completed by its
    end over its seconds."""
    completed = sum(1 for k in range(offered) if k in done and done[k] <= t_end)
    return {"fps": completed / (t_end - t0), "completed": completed,
            "not_completed": offered - completed}
