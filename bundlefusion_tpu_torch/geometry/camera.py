"""Pinhole camera model and depth<->camera-space conversions.

Port of ``bundlefusion_tpu/geometry/camera.py``: the same frozen
``CameraIntrinsics`` and the vectorised ``unproject`` / ``project`` on
torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def scaled(self, new_width: int, new_height: int) -> "CameraIntrinsics":
        """Rescale intrinsics for a resampled image."""
        sx = new_width / self.width
        sy = new_height / self.height
        return CameraIntrinsics(
            fx=self.fx * sx,
            fy=self.fy * sy,
            cx=self.cx * sx,
            cy=self.cy * sy,
            width=new_width,
            height=new_height,
        )

    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32
        )


def unproject(depth: torch.Tensor, intr: CameraIntrinsics) -> torch.Tensor:
    """Depth image [H, W] -> camera-space points [H, W, 3] (nan where the
    depth is invalid: non-finite or <= 0)."""
    H, W = depth.shape
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    z = depth
    x = (u - intr.cx) / intr.fx * z
    y = (v - intr.cy) / intr.fy * z
    pts = torch.stack(torch.broadcast_tensors(x, y, z), -1)
    valid = torch.isfinite(z) & (z > 0)
    return torch.where(valid[..., None], pts, torch.nan)


def project(pts: torch.Tensor, intr: CameraIntrinsics):
    """Camera-space points [..., 3] -> (uv [..., 2], z [...])."""
    z = pts[..., 2]
    u = pts[..., 0] / z * intr.fx + intr.cx
    v = pts[..., 1] / z * intr.fy + intr.cy
    return torch.stack([u, v], -1), z


def in_bounds(uv: torch.Tensor, intr: CameraIntrinsics, margin: float = 0.0) -> torch.Tensor:
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= margin)
        & (u <= intr.width - 1 - margin)
        & (v >= margin)
        & (v <= intr.height - 1 - margin)
    )


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample img [H, W] or [H, W, C] at uv [..., 2] (u=x, v=y).
    Out-of-bounds or non-finite neighborhoods return nan."""
    H, W = img.shape[:2]
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    # a non-finite coordinate converts to an arbitrary index; the clamp keeps
    # it in range and the bounds test below turns the sample into nan
    u0i = torch.clamp(torch.nan_to_num(u0, nan=0.0).to(torch.int64), 0, W - 1)
    v0i = torch.clamp(torch.nan_to_num(v0, nan=0.0).to(torch.int64), 0, H - 1)
    u1i = torch.clamp(u0i + 1, 0, W - 1)
    v1i = torch.clamp(v0i + 1, 0, H - 1)
    w00 = (1 - du) * (1 - dv)
    w01 = du * (1 - dv)
    w10 = (1 - du) * dv
    w11 = du * dv
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    if img.ndim == 3:
        w00, w01, w10, w11, inb = (w[..., None] for w in (w00, w01, w10, w11, inb))
    out = w00 * img[v0i, u0i] + w01 * img[v0i, u1i] + w10 * img[v1i, u0i] + w11 * img[v1i, u1i]
    return torch.where(inb, out, torch.nan)


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor sample (half-to-even rounding) with out-of-bounds
    -> nan."""
    H, W = img.shape[:2]
    ur = torch.round(uv[..., 0])
    vr = torch.round(uv[..., 1])
    inb = (ur >= 0) & (ur < W) & (vr >= 0) & (vr < H)
    uic = torch.clamp(torch.nan_to_num(ur, nan=0.0), 0, W - 1).to(torch.int64)
    vic = torch.clamp(torch.nan_to_num(vr, nan=0.0), 0, H - 1).to(torch.int64)
    out = img[vic, uic]
    if img.ndim == 3:
        inb = inb[..., None]
    return torch.where(inb, out, torch.nan)
