"""The controls of the comparison that decides ``correct``.

    python -m fusionbench.control --workload <name> --seeds <n> [<n> ...]
        [--breaks tracking|fusion|pose|render ...] [--lag L] [--frames N]

BundleFusion's parameter files state no number format, so a control breaks
one guarantee that the configuration states (``guarantees`` in its file).
The reference is put in the program's place, at the cell's own size, with
one guarantee broken by a step taken ``--lag`` frames (default 20, two
submaps) late, and its outputs go through the same comparison
(``check.compare`` and ``check.verdict``); the run has to come out not
correct:

- ``tracking``: each frame's reported pose (and the map and render that
  follow it) is the pose of the frame ``lag`` before, as if tracking ran
  that many frames behind the sensor;
- ``fusion``: each frame is fused at its pose and, a second time, at the
  pose of the frame ``lag`` before, as if a revised pose were re-integrated
  without de-integrating the old one;
- ``pose``: each frame is fused once, at the pose of the frame ``lag``
  before, while its own pose is reported (and rendered from), as if the
  map never took the revised poses in: right weights, wrong distances;
- ``render``: each frame is rendered from the pose of the frame ``lag``
  before while its own pose is reported.

Each number of ``check.py`` guards one of these guarantees, and its upper
reading is the reading of the control that breaks that guarantee. The
benchmark's runs never run this. Each seed and break prints one JSON line
with the numbers and whether the run is correct.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from fusionbench import check, reference, run, scan

BREAKS = ("tracking", "fusion", "pose", "render")


def lagged(poses: np.ndarray, lag: int) -> np.ndarray:
    """Frame k takes the pose of frame k - lag (the first frames their own)."""
    return poses[np.maximum(np.arange(len(poses)) - lag, 0)]


def surface_voxels(depths: list, poses: np.ndarray, cam: dict, tsdf: dict, n: int,
                   gen: torch.Generator, device) -> torch.Tensor:
    """``n`` voxel centres near the surfaces that the integration-size
    depths see from ``poses``: seeded pixels of seeded frames,
    back-projected, moved by up to half the truncation on each axis and
    snapped to the voxel grid."""
    vs = tsdf["voxel_size"]
    pick = torch.randint(len(depths), (n,), generator=gen, device=device).cpu().numpy()
    pts = []
    for f in np.unique(pick):
        d = depths[f]
        ok = torch.nonzero(torch.isfinite(d).reshape(-1)).reshape(-1)
        if ok.numel() == 0:
            continue
        lin = ok[torch.randint(ok.numel(), (int((pick == f).sum()),), generator=gen,
                               device=device)]
        v, u = (lin // cam["width"]).double(), (lin % cam["width"]).double()
        z = d.reshape(-1)[lin].double()
        pc = torch.stack([(u - cam["cx"]) / cam["fx"] * z, (v - cam["cy"]) / cam["fy"] * z, z], -1)
        T = torch.as_tensor(np.asarray(poses[f], np.float64), device=device)
        pts.append(pc @ T[:3, :3].T + T[:3, 3])
    p = torch.cat(pts)
    off = torch.rand(p.shape, generator=gen, device=device, dtype=torch.float64) - 0.5
    return (torch.floor((p + off * tsdf["truncation"]) / vs) + 0.5) * vs


def program_place(frames: dict, idx: np.ndarray, config: dict, seed: int, n_samples: int,
                  device, breaks: str = "tracking", lag: int = 20) -> dict:
    """The outputs that the reference gives in the program's place with the
    guarantee ``breaks`` broken."""
    truth = np.asarray(frames["poses"], np.float64)[idx]
    rel = reference.relative_poses(truth)
    cam = reference.integration_camera(config["camera"], *config["integration_size"])
    tsdf = config["tsdf"]
    gen = scan.noise_generator(seed + 1, device)
    stale = lagged(rel, lag)
    reported = stale if breaks == "tracking" else rel
    fused = stale if breaks == "pose" else reported
    render_pose = stale[-1] if breaks in ("tracking", "render") else reported[-1]
    depth = {int(i): reference.integration_depth(frames["depth"][i], cam["height"], cam["width"],
                                                 device) for i in np.unique(idx)}
    depths = [depth[int(i)] for i in idx]
    pts = surface_voxels(depths, fused, cam, tsdf, n_samples, gen, device)
    f = reference.Fusion(pts, tsdf)
    for k in range(len(idx)):
        f.add(depths[k], cam, fused[k])
        if breaks == "fusion":
            f.add(depths[k], cam, stale[k])
    sdf, w = f.result()
    seen = w > 0
    render = reference.render_depth(cam, truth[0] @ render_pose, device)
    return {"trajectory": reported, "scan_index": idx,
            "map": {"points": pts[seen].cpu().numpy(), "sdf": sdf[seen].cpu().numpy(),
                    "weight": w[seen].cpu().numpy()},
            "render": {"depth": render, "pose": reported[-1]}}


def control_runs(name: str, seed: int, frames_fed: int | None, device, breaks=("tracking",),
                 lag: int = 20, overrides: dict | None = None) -> list:
    """The controls ``breaks`` on one seed at the cell's size (``frames_fed``
    frames; by default what an open loop feeds in ``run_seconds``), from one
    render of the scan: for each, its numbers and which fail their limits."""
    spec = run.cell_spec(name)
    over = overrides or {}
    config = run.run_config(run.merge(spec["config"], over.get("config", {})))
    traffic = run.merge(spec["traffic"], over.get("traffic", {}))
    limits = run.merge(spec["limits"], over.get("limits", {}))
    if frames_fed is None:
        bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
        frames_fed = traffic["warm_frames"] + run.window_frames(traffic, bench["run_seconds"])
    n_render = frames_fed if traffic["loop"] == "open" else traffic["scan"]["frames"]
    frames = scan.make_scan(traffic, config["camera"], seed, n_render, device)
    idx = np.arange(frames_fed) % n_render
    out = []
    for b in breaks:
        outputs = program_place(frames, idx, config, seed, limits["map_samples"], device, b, lag)
        numbers = check.compare(outputs, frames, config, device)
        correct, checks = check.verdict(numbers, limits)
        out.append({"workload": name, "seed": seed, "breaks": b, "lag": lag,
                    "frames": frames_fed, "correct": correct, "numbers": numbers,
                    "fails": [k for k, c in checks.items()
                              if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the controls of the benchmark's comparison")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--breaks", choices=BREAKS, nargs="+", default=["tracking"])
    p.add_argument("--lag", type=int, default=20)
    p.add_argument("--frames", type=int, default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fusionbench.control: no CUDA card", file=sys.stderr)
        return 2
    for s in a.seeds:
        for out in control_runs(a.workload, s, a.frames, torch.device("cuda"), a.breaks, a.lag):
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
