"""The comparison that decides ``correct``.

The program's outputs, read once the window has closed, are held against
the plain reference (``reference.py``), which works them out again from the
generated frames. Each number guards one guarantee that the configuration
states (``guarantees`` in its file). A cell compares the numbers that its
``limits/<cell>.json`` gives a limit (how each was set is in ``PERF.md``),
one or more for each guarantee, and a run is correct when every number
compared is at or below its limit; the others are logged:

- tracking, ``pose_err_rms_cm``: the root mean square, over every frame the
  program keeps valid, of the distance between its camera centre
  (``trajectory()`` after ``finish``) and the true one, both relative to
  the first frame fed (no alignment: the program anchors its world there);
  ``pose_ate_cm``: the same after the rigid alignment of the valid frames'
  centres that BundleFusion's ``evaluateAteRmse`` makes, which leaves out a
  drift that turns the whole trajectory about its anchor (on a long walk
  it grows with the distance from the first frame, and a tracking lag
  does not align away);
- fusion, ``map_weight_gap``: a seeded sample of the program's observed
  voxels, against the reference's fusion of every valid frame fed, once,
  at the pose the program reports for it (its trajectory, the output
  judged, as a served model's tokens are), over the sampled voxels within
  half the truncation of the reference's surface: how often each voxel was
  fused, ``map_weight_gap`` = |1 - median(weight ratio)|, and what it
  stores, ``map_sdf_off_pct``, the share of those voxels whose sdf lies
  more than one voxel from the reference's (a frame fused at another pose
  than the one reported moves it), and ``map_sdf_far_pct``, the share
  whose sdf lies more than half the truncation from it (the surface the
  voxel holds that far from the reference's: on a long walk the loop
  closures revise thousands of poses by a voxel or two, more than the
  re-integration budget catches up with by design, which the share off by
  one voxel counts and this one does not). The median and 95th percentile of the
  |sdf difference| (``map_sdf_p50_mm``, ``map_sdf_p95_mm``) are logged
  beside it, not compared: the scan's camera looks at the room's centre,
  where a frame fused at a stale pose lands near its true place, so the
  median stays that of a sound map, and the map lags the trajectory by
  design (a re-integration budget a frame), which widens a sound map's
  tail (``PERF.md``);
- the render, ``render_depth_p50_mm``: the median |depth| difference
  between the last per-frame render and the depth of the traffic's own
  scene from the pose that frame's ``process_frame`` returned (the pose it was rendered from),
  over the pixels where both hold a depth.

A number with too little to read (under ``MIN_SAMPLES`` voxels or under 1 %
of the reference's pixels) reads infinity, and so fails.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fusionbench import reference

NUMBERS = ("pose_err_rms_cm", "pose_ate_cm", "map_weight_gap", "map_sdf_off_pct",
           "map_sdf_far_pct", "render_depth_p50_mm")
MIN_SAMPLES = 1000
NEAR_SURFACE = 0.5   # of the base truncation


def pose_errors_cm(trajectory: np.ndarray, truth_rel: np.ndarray):
    """(rms, max) distance in cm between the valid frames' camera centres
    and the true ones; infinity when there is no valid frame to read."""
    traj = np.asarray(trajectory, np.float64)
    if traj.shape != truth_rel.shape:
        return math.inf, math.inf
    ok = np.isfinite(traj).all((1, 2))
    if not ok.any():
        return math.inf, math.inf
    err = np.linalg.norm(traj[ok, :3, 3] - truth_rel[ok, :3, 3], axis=1)
    return float(100.0 * np.sqrt((err * err).mean())), float(100.0 * err.max())


def leg_gap_cm(trajectory: np.ndarray, truth_rel: np.ndarray, scan_index: np.ndarray,
               n_total: int) -> float:
    """How far a walk's way back departs from its way out (logged, not
    compared): the root mean square, in cm, over the valid fed frames of
    the second half of the scan (scan frame i) whose mirror on the way out
    (scan frame n - i, near the same place) was fed and is valid, of the
    error of the camera centre's offset from the mirror's, (c_i - c_m) -
    (t_i - t_m). Where the way back is held to the way out by loop closures
    it stays near the tracking noise, even while both share a drift about
    the first frame; nan where no such pair was fed."""
    traj = np.asarray(trajectory, np.float64)
    if traj.shape != truth_rel.shape:
        return math.nan
    ok = np.isfinite(traj).all((1, 2))
    first = {}
    for k, i in enumerate(np.asarray(scan_index)):
        first.setdefault(int(i), k)
    errs = []
    for k, i in enumerate(np.asarray(scan_index)):
        m = first.get(n_total - int(i))
        if 2 * int(i) <= n_total or m is None or not (ok[k] and ok[m]):
            continue
        e = (traj[k, :3, 3] - traj[m, :3, 3]) - (truth_rel[k, :3, 3] - truth_rel[m, :3, 3])
        errs.append(float(e @ e))
    return float(100.0 * math.sqrt(sum(errs) / len(errs))) if errs else math.nan


def map_numbers(sample: dict, ref_sdf: torch.Tensor, ref_w: torch.Tensor, tsdf: dict) -> dict:
    """The map's numbers from the program's sampled voxels and the
    reference's sdf and weight at the same centres."""
    n = int(ref_w.shape[0])
    out = {"map_sdf_p50_mm": math.inf, "map_sdf_p95_mm": math.inf, "map_sdf_off_pct": math.inf,
           "map_sdf_far_pct": math.inf, "map_weight_gap": math.inf, "map_samples": n,
           "map_compared": 0, "map_unseen_share": math.inf}
    if n < MIN_SAMPLES:
        return out
    dev = ref_w.device
    sdf = torch.as_tensor(sample["sdf"], dtype=torch.float64, device=dev)
    w = torch.as_tensor(sample["weight"], dtype=torch.float64, device=dev)
    seen = ref_w > 0
    near = seen & (torch.abs(ref_sdf) < NEAR_SURFACE * tsdf["truncation"])
    out["map_unseen_share"] = float((~seen).double().mean())
    out["map_compared"] = int(near.sum())
    if out["map_compared"] >= MIN_SAMPLES:
        diff = torch.abs(sdf - ref_sdf)[near]
        out["map_sdf_p95_mm"] = float(1e3 * torch.quantile(diff, 0.95))
        out["map_sdf_p50_mm"] = float(1e3 * torch.quantile(diff, 0.5))
        out["map_sdf_off_pct"] = float(100.0 * (diff > tsdf["voxel_size"]).double().mean())
        far = NEAR_SURFACE * tsdf["truncation"]
        out["map_sdf_far_pct"] = float(100.0 * (diff > far).double().mean())
        out["map_weight_gap"] = float(abs(1.0 - torch.median(w[near] / ref_w[near])))
    return out


def render_depth_p50_mm(render: np.ndarray, truth: np.ndarray) -> float:
    if render is None:
        return math.inf
    render = np.asarray(render, np.float64)
    truth = np.asarray(truth, np.float64)
    if render.shape != truth.shape:
        return math.inf
    both = np.isfinite(render) & np.isfinite(truth)
    if both.sum() < 0.01 * max(np.isfinite(truth).sum(), 1):
        return math.inf
    return float(1e3 * np.median(np.abs(render[both] - truth[both])))


def compare(outputs: dict, frames: dict, config: dict, device, scene=None) -> dict:
    """Every number of the comparison (and the counts behind them).

    ``outputs``: ``trajectory`` [F, 4, 4] (nan where invalid), ``scan_index``
    [F] (the generated frame each fed frame was), ``map`` (``points`` [M, 3]
    voxel centres in metres, ``sdf`` and ``weight`` [M]), ``render``
    (``depth`` [h, w] or None, ``pose``: the pose it was rendered from),
    poses relative to the first frame fed. ``frames``: the generated
    ``depth`` (uint16 mm) and true ``poses``. ``scene``: the traffic's
    ``scan.scene`` (None for the one room), which the render is held
    against."""
    idx = np.asarray(outputs["scan_index"])
    truth = np.asarray(frames["poses"], np.float64)
    rel = reference.relative_poses(truth[idx])
    traj = np.asarray(outputs["trajectory"], np.float64)
    tsdf = config["tsdf"]
    cam_int = reference.integration_camera(config["camera"], *config["integration_size"])
    rms, worst = pose_errors_cm(traj, rel)
    ate = 100.0 * reference.ate_rmse(traj, rel)[0] if traj.shape == rel.shape else math.inf
    out = {"pose_err_rms_cm": rms, "pose_err_max_cm": worst, "pose_ate_cm": ate,
           "frames_fed": int(len(idx))}

    pts = torch.as_tensor(np.asarray(outputs["map"]["points"]), dtype=torch.float64,
                          device=device)
    fusion = reference.Fusion(pts, tsdf)
    if traj.shape == rel.shape:
        cache = {}
        for k, i in enumerate(idx):
            if not np.isfinite(traj[k]).all():
                continue
            i = int(i)
            if i not in cache:
                cache[i] = reference.integration_depth(frames["depth"][i], cam_int["height"],
                                                       cam_int["width"], device)
            fusion.add(cache[i], cam_int, traj[k])
    ref_sdf, ref_w = fusion.result()
    out.update(map_numbers(outputs["map"], ref_sdf, ref_w, tsdf))

    r = outputs["render"]
    if r["depth"] is None or r["pose"] is None or not np.isfinite(r["pose"]).all():
        out["render_depth_p50_mm"] = math.inf
    else:
        scene_pose = truth[idx[0]] @ np.asarray(r["pose"], np.float64)
        truth_depth = reference.render_depth(cam_int, scene_pose, device, scene)
        out["render_depth_p50_mm"] = render_depth_p50_mm(r["depth"], truth_depth)
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) for the numbers that
    ``limits`` gives a limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
