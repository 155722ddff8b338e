"""What the modules of ``bundlefusion_tpu_torch.scripts`` share: the
command line's ``--device`` / ``--out``, the device they resolve to, the
small test configuration, timing and memory readings that exist only on the
card, and JSON written under ``--out``."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "scripts")


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the small "
                        "configuration on the CPU)")
    p.add_argument("--out", default=DEFAULT_OUT, help="directory for the JSON results")
    return p


def resolve_device(name) -> torch.device:
    """The named device, or the CUDA card (raises without one: no silent
    fall-back to the CPU)."""
    from bundlefusion_tpu_torch import default_device

    return torch.device(name) if name is not None else default_device()


def platform(dev: torch.device) -> str:
    """What a result says it ran on: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def gpu_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_mem_gb(dev: torch.device):
    """Peak device memory allocated since the last ``reset_peak``; None
    off the card (not measured)."""
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def wall_ms(dev: torch.device, fn):
    """(ms, result) of ``fn()`` by the host clock between two waits for
    the device."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3, out


def event_ms(dev: torch.device, fn, reps: int = 5):
    """(median ms by CUDA events over ``reps`` calls after one untimed
    call, result of the last call); ms is None off the card, where only one
    call runs (not measured)."""
    out = fn()
    if dev.type != "cuda":
        return None, out
    sync(dev)
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    ts.sort()
    return ts[len(ts) // 2], out


def drive(eng, frames, untimed: int = 0, extra_solves=None, progress=None) -> dict:
    """Run ``frames`` through ``eng.process_frame``: the first ``untimed``
    frames off the clock, the rest on the host clock between two waits for
    the device, then ``eng.finish(extra_solves)`` timed alone (skipped when
    ``extra_solves`` is None). ``frames`` is a list of argument tuples of
    ``process_frame``: ``(handle,)`` from ``upload_frame`` or ``(depth,
    color)``; each entry is dropped once processed, so that a run with every
    frame uploaded frees them as it goes. ``progress(done,
    t0)``, when given, runs after each timed frame with the frames done and
    the loop's start on ``time.perf_counter``. Returns ``fps`` and
    ``ms_per_frame`` of the timed frames, ``finish_s`` and ``peak_mem_gb``
    (from the first frame on)."""
    dev = eng.device
    reset_peak(dev)

    def step(i):
        eng.process_frame(*frames[i])
        frames[i] = None

    for i in range(untimed):
        step(i)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(untimed, len(frames)):
        step(i)
        if progress is not None:
            progress(i + 1, t0)
    sync(dev)
    elapsed = time.perf_counter() - t0
    timed = len(frames) - untimed
    out = {"fps": timed / elapsed, "ms_per_frame": 1e3 * elapsed / timed, "finish_s": None}
    if extra_solves is not None:
        t1 = time.perf_counter()
        eng.finish(extra_solves=extra_solves)
        sync(dev)
        out["finish_s"] = time.perf_counter() - t1
    out["peak_mem_gb"] = peak_mem_gb(dev)
    return out


def write_json(out_dir: str, name: str, obj) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
    return path


def small_config(submap_size: int = 4, **bundling):
    """The small test configuration (``tests/test_pipeline_e2e.py``, the JAX
    scripts' CPU branch): (intr, app, bundling, sift_cfg) at 160x120 input,
    80x60 integration, 3 cm voxels, 8192 blocks."""
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
    from bundlefusion_tpu_torch.io.synthetic import default_intrinsics
    from bundlefusion_tpu_torch.ops.sift import SiftConfig

    intr = default_intrinsics(160, 120)
    app = AppConfig(
        integration_width=80, integration_height=60, sdf_voxel_size=0.03,
        sdf_truncation=0.09, hash_num_sdf_blocks=8192, hash_key_capacity=16384,
        visible_blocks_cap=8192,
    )
    bund = BundlingConfig(**{
        **dict(width_sift=160, height_sift=120, submap_size=submap_size,
               downsampled_width=40, downsampled_height=30,
               max_local_corr=2048, max_global_corr=8192,
               min_num_matches_local=4, min_num_matches_global=4),
        **bundling,
    })
    sift_cfg = SiftConfig(num_octaves=3, target_keys=96, max_candidates_per_octave=256,
                          min_scale=1.0, dog_thresh=0.004)
    return intr, app, bund, sift_cfg


def card_sift(app, bundling, min_scale=None):
    """The scripts' SIFT configuration on the card (150 keys)."""
    from bundlefusion_tpu_torch.ops.sift import SiftConfig

    return SiftConfig(
        target_keys=150,
        min_scale=bundling.min_key_scale if min_scale is None else min_scale,
        depth_min=app.sensor_depth_min, depth_max=app.sensor_depth_max,
    )


def validity(traj):
    """Per-frame validity of a trajectory (all entries finite)."""
    return np.isfinite(traj).all((1, 2))
