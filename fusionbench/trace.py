"""Reading ``torch.profiler`` stretches of a traced window.

Two stretches are taken inside the window of a ``--trace 1`` run: one with
device activity alone (busy and idle time, device time by operation and by
hand kernel, at the least cost to the host) and a short one with host
activity too, whose host events and the benchmark's own annotations name
what the host was doing while the device sat idle.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# the program's hand kernels (bundlefusion_tpu_torch/kernels/*.cu)
HAND_KERNELS = ("tsdf_prepare_kernel", "tsdf_cull_kernel", "tsdf_apply_kernel",
                "kabsch_filter_kernel", "surface_area_kernel")
GAP_MIN_S = 20e-6   # shorter gaps are launch spacing, not idling
ANNOTATION = "fusionbench."


class Stretch:
    """A profiler stretch: ``start()`` before the first frame, ``stop(sync)``
    after the last one has been offered; ``stop`` waits for the device."""

    def __init__(self, host: bool):
        acts = [torch.profiler.ProfilerActivity.CPU] if host else []
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts) if acts else None
        self.frames = 0
        self.wall_s = None

    def start(self) -> None:
        if self.prof is not None:
            self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, sync) -> None:
        sync()
        self.wall_s = time.perf_counter() - self.t0
        if self.prof is not None:
            self.prof.stop()

    def events(self):
        """(device events, host events): lists of (name, start_us, end_us)."""
        dev, host = [], []
        if self.prof is None:
            return dev, host
        for e in self.prof.events():
            tr = e.time_range
            rec = (e.name, float(tr.start), float(tr.end))
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host.append(rec)
            elif not (getattr(e, "is_user_annotation", False) or e.name.startswith(ANNOTATION)):
                # an annotation's device-side copy spans its range's idle
                # time too: it is no device activity
                dev.append(rec)
        if not dev:
            # device activity with no host op to hang it on: read Kineto's
            # own list (ns since its start, in the same clock as the host's)
            for ke in self.prof.profiler.kineto_results.events():
                if (ke.device_type() != torch.autograd.DeviceType.CUDA
                        or ke.name().startswith(ANNOTATION)):
                    continue
                s = ke.start_ns() * 1e-3
                dev.append((ke.name(), s, s + ke.duration_ns() * 1e-3))
        return dev, host


def merged(intervals):
    """Union of [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_summary(stretch: Stretch) -> dict:
    """Busy seconds, the stretch's wall seconds, device seconds by
    operation (top 10) and of the hand kernels."""
    dev, _ = stretch.events()
    if not dev:
        return {}
    busy = sum(e - s for s, e in merged([(s, e) for _, s, e in dev])) * 1e-6
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    hand = sum(v for k, v in by_name.items() if any(h in k for h in HAND_KERNELS))
    return {"busy_s": busy, "window_s": stretch.wall_s, "frames": stretch.frames,
            "device_ops": [[k, v] for k, v in top], "hand_kernel_s": hand}


def idle_gaps(stretch: Stretch, longest: int = 400) -> list:
    """Idle device time by what the host was doing, the top 10: each gap
    between device activity is named by the benchmark's annotation and the
    innermost host event that cover its middle."""
    dev, host = stretch.events()
    if not dev or not host:
        return []
    busy = merged([(s, e) for _, s, e in dev])
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])
            if (b[0] - a[1]) * 1e-6 >= GAP_MIN_S]
    gaps = sorted(gaps, reverse=True)[:longest]
    names = [n for n, _, _ in host]
    st = np.array([s for _, s, _ in host])
    en = np.array([e for _, _, e in host])
    span = en - st
    by_label = {}
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        cover = np.nonzero((st <= mid) & (en >= mid))[0]
        ann = [i for i in cover if names[i].startswith(ANNOTATION)]
        ops = [i for i in cover if not names[i].startswith(ANNOTATION)]
        where = names[ann[0]][len(ANNOTATION):] if ann else "outside a frame"
        what = names[min(ops, key=lambda i: span[i])] if ops else "python"
        label = f"{where}: {what}"
        by_label[label] = by_label.get(label, 0.0) + length * 1e-6
    return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]
