"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy written from the reference's equations; it imports
nothing of the program. It takes the generated frames and their true poses
(the inputs the benchmark made) and works out what the program's outputs
should be:

- poses: frame ``i`` relative to the first frame fed (the program anchors
  its world at that frame), ``inv(P_0) @ P_i``;
- the map: the truncated signed distance and weight of any voxel centre,
  fused from frames at given poses, as BundleFusion's
  ``integrateDepthMapKernel`` does: each frame's depth is decoded from
  millimetres, eroded twice (``erodeDepthMap``), resampled to the
  integration size by nearest neighbour, and each voxel that projects onto a
  valid sample with ``sdf > -truncation`` adds weight 1 and its sdf clamped
  to the truncation, which grows with depth;
- the render: the scene's depth from the frame's true pose, traced from the
  analytic scene.

Everything is accumulated in float64 on the device it is given.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fusionbench import scan


def relative_poses(poses: np.ndarray) -> np.ndarray:
    """[N, 4, 4] camera to world -> the same relative to frame 0."""
    p = np.asarray(poses, np.float64)
    return np.linalg.inv(p[0])[None] @ p


def ate_rmse(est: np.ndarray, gt: np.ndarray):
    """ATE RMSE (metres) of the translations of ``est`` against ``gt``
    ([N, 4, 4] each), Kabsch-aligned over the frames where both are finite,
    as BundleFusion's ``PoseHelper::evaluateAteRmse``. Returns (rmse,
    frames used); inf with fewer than 3 frames."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    ok = np.isfinite(est).all((1, 2)) & np.isfinite(gt).all((1, 2))
    n = int(ok.sum())
    if n < 3:
        return math.inf, n
    pe, pg = est[ok][:, :3, 3], gt[ok][:, :3, 3]
    me, mg = pe.mean(0), pg.mean(0)
    U, _, Vt = np.linalg.svd((pe - me).T @ (pg - mg))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    err = pe @ R.T + (mg - R @ me) - pg
    return float(np.sqrt((err * err).sum(1).mean())), n


def integration_camera(camera: dict, width: int, height: int) -> dict:
    """The input camera rescaled to the integration size."""
    sx, sy = width / camera["width"], height / camera["height"]
    return {"fx": camera["fx"] * sx, "fy": camera["fy"] * sy, "cx": camera["cx"] * sx,
            "cy": camera["cy"] * sy, "width": width, "height": height}


def erode(depth: torch.Tensor, radius: int = 2, dist_thresh: float = 0.1,
          frac_req: float = 0.4) -> torch.Tensor:
    """``erodeDepthMap``: a pixel survives when at least ``frac_req`` of its
    (2r+1)^2 neighbours (wrapping at the borders) lie within
    ``dist_thresh * max(depth, 1)`` of it."""
    valid = torch.isfinite(depth)
    d0 = torch.where(valid, depth, 0.0)
    thr = dist_thresh * torch.clamp(depth, min=1.0)
    dn = torch.where(valid, depth, torch.nan)
    cnt = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = torch.roll(torch.roll(dn, dy, 0), dx, 1)
            cnt += (torch.abs(nb - d0) < thr).to(torch.int32)
    keep = valid & (cnt.to(depth.dtype) >= frac_req * (2 * radius + 1) ** 2)
    return torch.where(keep, depth, torch.nan)


def nearest(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour resample, pixel centres rounded half to even."""
    H, W = img.shape[:2]
    vs = (torch.arange(h, dtype=torch.float32, device=img.device) + 0.5) * (H / h) - 0.5
    us = (torch.arange(w, dtype=torch.float32, device=img.device) + 0.5) * (W / w) - 0.5
    vi = torch.clamp(torch.round(vs), 0, H - 1).to(torch.int64)
    ui = torch.clamp(torch.round(us), 0, W - 1).to(torch.int64)
    return img.index_select(0, vi).index_select(1, ui)


def integration_depth(depth_mm: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """One wire frame's depth as the fusion samples it: metres, eroded
    twice, resampled to [h, w] (nan where invalid)."""
    d = torch.as_tensor(depth_mm.astype(np.int32), device=device)
    d = torch.where(d > 0, d.to(torch.float32) * 1e-3, torch.nan)
    return nearest(erode(erode(d)), h, w)


class Fusion:
    """Running TSDF sums at fixed voxel centres [M, 3] (metres, in the
    first frame's camera frame)."""

    def __init__(self, points: torch.Tensor, tsdf: dict):
        self.p = points.to(torch.float64)
        self.tsdf = tsdf
        self.sum = torch.zeros(points.shape[0], dtype=torch.float64, device=points.device)
        self.weight = torch.zeros(points.shape[0], dtype=torch.float64, device=points.device)

    def add(self, depth: torch.Tensor, cam: dict, cam_to_world: np.ndarray) -> None:
        """Fuse one integration-size depth image [h, w] taken from
        ``cam_to_world``."""
        t = self.tsdf
        w2c = torch.as_tensor(np.linalg.inv(np.asarray(cam_to_world, np.float64)),
                              device=self.p.device)
        pc = self.p @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        zs = torch.clamp(z, min=1e-6)
        u = torch.round(pc[:, 0] / zs * cam["fx"] + cam["cx"])
        v = torch.round(pc[:, 1] / zs * cam["fy"] + cam["cy"])
        inb = (u >= 0) & (u < cam["width"]) & (v >= 0) & (v < cam["height"]) & (z > 0)
        lin = (torch.clamp(v, 0, cam["height"] - 1) * cam["width"]
               + torch.clamp(u, 0, cam["width"] - 1)).to(torch.int64)
        d = depth.reshape(-1)[lin].double()
        ok = (torch.isfinite(d) & (d >= t["depth_min"])
              & (d <= min(t["depth_max"], t["max_integration_distance"])))
        trunc = t["truncation"] + t["truncation_scale"] * d
        sdf = d - z
        upd = inb & ok & (sdf > -trunc)
        self.sum += torch.where(upd, torch.minimum(sdf, trunc), 0.0)
        self.weight += upd.double()

    def result(self):
        """(sdf [M], weight [M]) float64; sdf 0 where nothing was fused."""
        w = self.weight
        return torch.where(w > 0, self.sum / torch.clamp(w, min=1.0), 0.0), w


def render_depth(camera_int: dict, cam_to_world: np.ndarray, device) -> np.ndarray:
    """The scene's depth [h, w] (metres, nan where nothing is hit) from
    ``cam_to_world`` in the scene's frame, at the integration camera."""
    d, _ = scan.render(scan.Scene(device), camera_int, np.asarray(cam_to_world)[None])
    return d[0].cpu().numpy()
