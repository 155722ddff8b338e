"""Per-frame stage timing, mirroring the reference's TimingLog.

Port of ``bundlefusion_tpu/utils/timing.py``: a ``FrameTiming`` record per
frame with per-stage times, local/global lists, averaged printout and CSV
export. Times are host wall-clock. PyTorch enqueues work on the card and
returns, so a stage's time is its enqueue cost unless the log was given a
``sync`` callable (``torch.cuda.synchronize``), which then runs when a stage
opens and when it closes: the stage's time is its own device work plus its
host work, at the price of draining the card twice per stage.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass
class FrameTiming:
    frame: int = -1
    time_sift_detection: float = 0.0
    time_sift_matching: float = 0.0
    time_match_filter_key_point: float = 0.0
    time_match_filter_surface_area: float = 0.0
    time_match_filter_dense_verify: float = 0.0
    time_misc: float = 0.0
    time_solve: float = 0.0
    num_iters_solve: int = 0
    time_sensor_process: float = 0.0
    time_re_integrate: float = 0.0
    time_reconstruct: float = 0.0
    time_visualize: float = 0.0
    time_frame_step: float = 0.0
    time_submap_step: float = 0.0


class TimingLog:
    """Collects per-frame stage timings; context-manager based."""

    def __init__(self, enabled: bool = True, sync: Optional[Callable[[], None]] = None):
        self.enabled = enabled
        self.sync = sync
        self.local_frames: List[FrameTiming] = []
        self.global_frames: List[FrameTiming] = []
        self._samples: Dict[str, List[float]] = defaultdict(list)

    def new_frame(self, frame_idx: int, is_local: bool = True) -> FrameTiming:
        ft = FrameTiming(frame=frame_idx)
        (self.local_frames if is_local else self.global_frames).append(ft)
        return ft

    class _Stage:
        def __init__(self, log: "TimingLog", ft: Optional[FrameTiming], attr: str):
            self.log, self.ft, self.attr = log, ft, attr

        def __enter__(self):
            if self.log.sync is not None:
                self.log.sync()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if self.log.sync is not None:
                self.log.sync()
            dt = time.perf_counter() - self.t0
            if self.ft is not None:
                setattr(self.ft, self.attr, getattr(self.ft, self.attr) + dt)
            self.log.add(self.attr, dt)
            return False

    def stage(self, attr: str, ft: Optional[FrameTiming] = None) -> "_Stage":
        return TimingLog._Stage(self, ft, attr)

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

    def to_csv(self, path: str, which: str = "local") -> None:
        frames = self.local_frames if which == "local" else self.global_frames
        cols = list(FrameTiming.__dataclass_fields__.keys())
        with open(path, "w") as fh:
            fh.write(",".join(cols) + "\n")
            for ft in frames:
                fh.write(",".join(str(getattr(ft, c)) for c in cols) + "\n")


def stage(log: Optional[TimingLog], attr: str):
    """``log.stage(attr)``, or a no-op context when there is no log (or it
    is disabled): lets library functions take an optional log."""
    if log is None or not log.enabled:
        return nullcontext()
    return log.stage(attr)
