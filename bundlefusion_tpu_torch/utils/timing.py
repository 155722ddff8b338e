"""The engine's stage times, and its spans and counters while it traces.

The port's counterpart of the reference's ``TimingLog``, and the one
recorder of where the engine's time goes:

- ``stage(attr)``: a host wall-clock stage whose seconds join ``attr``'s
  samples (``averages``, ``medians``, ``totals``, ``print_all_timings``).
  PyTorch enqueues work on the card and returns, so a stage's time is its
  enqueue cost unless the log was given a ``sync`` callable
  (``torch.cuda.synchronize``), which then runs when a stage opens and when
  it closes: the stage's time is its own device work plus its host work, at
  the price of draining the card twice per stage.
- While the log traces (``trace(True)``), each stage is also a span, and
  ``span(name)`` opens a span that is not a stage. A span's record holds its
  name, its id and its parent's, the frame index, its host start and end
  (``time.perf_counter_ns``), its self time (the end less the start less
  its children's), the host's wait for the card while it was the innermost
  open span (``waited``: the counted reads of ``utils`` report each one) and
  that wait summed over its subtree, and its counters (``count``), its own
  and summed over its subtree. ``spans()`` hands the records over and
  forgets them. With ``profiler_ranges`` each span is also a
  ``torch.profiler.record_function`` range named ``bf.<name>``, so the spans
  sit on the profiler's clock, in the trace of the card's work.
- With tracing off a stage costs what it cost before spans existed (two
  clock reads and a sample), and ``span``, ``count`` and ``waited`` do
  nothing.

One log traces at a time; the solver and the counted reads, which hold no
log, reach it through :func:`active`.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional

PROFILER_PREFIX = "bf."   # the profiler ranges' names: bf.<span name>

_OFF = nullcontext()      # the span of a log that is not tracing
_active: Optional["TimingLog"] = None


def active() -> Optional["TimingLog"]:
    """The log that is tracing, or None."""
    return _active


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span of the log
    that is tracing; nothing while none is."""
    log = _active
    if log is not None and log._open:
        c = log._open[-1].counters
        c[name] = c.get(name, 0) + n


@contextmanager
def paused():
    """No log is active inside, so counts and waits go nowhere: a CUDA
    graph's capture records work that it does not run."""
    global _active
    log, _active = _active, None
    try:
        yield
    finally:
        _active = log


def waited(ns: int, what: str = "reads") -> None:
    """Charge ``ns`` of host time blocked on the card, and one to counter
    ``what``, to the innermost open span of the log that is tracing."""
    log = _active
    if log is not None and log._open:
        sp = log._open[-1]
        sp.wait_ns += ns
        sp.counters[what] = sp.counters.get(what, 0) + 1


class _Span:
    __slots__ = ("log", "name", "frame", "id", "parent", "t0", "child_ns", "wait_ns",
                 "sub_wait_ns", "counters", "sub_counters", "range", "record")

    def __init__(self, log: "TimingLog", name: str, frame: Optional[int]):
        self.log, self.name = log, name
        self.frame = log.frame if frame is None else frame
        self.child_ns = self.wait_ns = self.sub_wait_ns = 0
        self.counters: Dict[str, int] = {}
        self.sub_counters: Dict[str, int] = {}
        self.range = self.record = None

    def __enter__(self) -> "_Span":
        log = self.log
        self.parent = log._open[-1] if log._open else None
        self.id = log._next_id
        log._next_id += 1
        log._open.append(self)
        if log.profiler_ranges:
            import torch

            self.range = torch.profiler.record_function(PROFILER_PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        log = self.log
        log._open.pop()
        dur = t1 - self.t0
        wait_incl = self.wait_ns + self.sub_wait_ns
        counters_incl = dict(self.sub_counters)
        for k, v in self.counters.items():
            counters_incl[k] = counters_incl.get(k, 0) + v
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
            parent.sub_wait_ns += wait_incl
            for k, v in counters_incl.items():
                parent.sub_counters[k] = parent.sub_counters.get(k, 0) + v
        self.record = {
            "name": self.name, "id": self.id,
            "parent": None if parent is None else parent.id, "frame": self.frame,
            "t0_ns": self.t0, "t1_ns": t1, "self_ns": dur - self.child_ns,
            "wait_ns": self.wait_ns, "wait_incl_ns": wait_incl,
            "counters": self.counters, "counters_incl": counters_incl,
        }
        log._records.append(self.record)
        return False


class TimingLog:
    """Host stage times (context managers); while tracing, span records."""

    def __init__(self, enabled: bool = True, sync: Optional[Callable[[], None]] = None):
        self.enabled = enabled
        self.sync = sync
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self.frame = -1              # the frame index new spans are tagged with
        self.tracing = False
        self.profiler_ranges = False
        self._open: List[_Span] = []
        self._records: List[dict] = []
        self._next_id = 0

    class _Stage:
        def __init__(self, log: "TimingLog", attr: str):
            self.log, self.attr = log, attr

        def __enter__(self):
            log = self.log
            if log.sync is not None:
                log.sync()
            if log.tracing:
                self.span = _Span(log, self.attr, None).__enter__()
            else:
                self.span = None
                self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            log = self.log
            if log.sync is not None:
                log.sync()
            if self.span is None:
                dt = time.perf_counter() - self.t0
            else:
                self.span.__exit__()
                rec = self.span.record
                dt = 1e-9 * (rec["t1_ns"] - rec["t0_ns"])
            log.add(self.attr, dt)
            return False

    def stage(self, attr: str) -> "_Stage":
        return TimingLog._Stage(self, attr)

    def span(self, name: str, frame: Optional[int] = None):
        """A span that is not a stage, while tracing (tagged ``frame``, or
        the log's current frame); a context that does nothing otherwise. Its
        ``__enter__`` returns the span, whose ``record`` is set on exit, or
        None."""
        return _Span(self, name, frame) if self.tracing else _OFF

    def trace(self, on: bool, profiler_ranges: bool = False) -> None:
        """Start or stop keeping span records (with ``profiler_ranges``, as
        profiler ranges too). The log that starts tracing becomes
        :func:`active`, in place of any other."""
        global _active
        if on:
            if _active is not None and _active is not self:
                _active.trace(False)
            _active = self
        elif _active is self:
            _active = None
        self.tracing = on
        self.profiler_ranges = on and profiler_ranges

    def spans(self) -> List[dict]:
        """The records of the spans closed since the last call, in the order
        they closed (a child before its parent); forgotten here."""
        out, self._records = self._records, []
        return out

    def reset(self) -> None:
        """Forget every sample and record; tracing stays as it is."""
        self._samples.clear()
        self._records = []

    def add(self, attr: str, dt: float) -> None:
        """Record one sample directly."""
        self._samples[attr].append(dt)

    def averages(self) -> Dict[str, float]:
        return {k: statistics.fmean(v) for k, v in sorted(self._samples.items())}

    def medians(self) -> Dict[str, float]:
        return {k: statistics.median(v) for k, v in sorted(self._samples.items())}

    def totals(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self._samples.items()}

    def print_all_timings(self) -> str:
        lines = ["stage, total_s, count, mean_ms"]
        for k, v in sorted(self._samples.items()):
            lines.append(f"{k}, {sum(v):.4f}, {len(v)}, {1000.0 * statistics.fmean(v):.3f}")
        out = "\n".join(lines)
        print(out)
        return out


def stage(log: Optional[TimingLog], attr: str):
    """``log.stage(attr)``, or a no-op context when there is no log (or it
    is disabled): lets library functions take an optional log."""
    if log is None or not log.enabled:
        return nullcontext()
    return log.stage(attr)
