"""Depth/color image preprocessing ops.

Port of ``bundlefusion_tpu/ops/image.py``: resampling, intensity
conversion, depth erosion, the bilateral and gaussian filters, normals and
intensity derivatives on [H, W(, C)] float32 tensors; invalid depth is nan.

The reference writes every (2r+1)^2 window as that many shifted adds (cheap
on a TPU's vector unit); here a window is one ``unfold`` of the
circularly padded image, so a filter is a handful of calls. Neighbours wrap
around at the image edge exactly as ``jnp.roll`` does.
"""

from __future__ import annotations

from functools import cache

import torch
import torch.nn.functional as F

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics, unproject


def _wrapped_windows(img: torch.Tensor, radius: int) -> torch.Tensor:
    """[H, W] -> [(2r+1)^2, H, W]: entry (dy, dx) (row-major, both from -r
    to r) is ``roll(roll(img, dy, 0), dx, 1)``, the neighbour at
    (y - dy, x - dx) with wrap-around."""
    H, W = img.shape
    k = 2 * radius + 1
    padded = F.pad(img[None, None], (radius,) * 4, mode="circular")
    win = F.unfold(padded, kernel_size=k).reshape(k * k, H, W)
    # unfold's entry (ky, kx) reads (y + ky - r, x + kx - r): dy = r - ky
    return win.flip(0)


def resample_nearest(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Nearest-neighbor resample (depth: never mixes surfaces). Pixel
    centres round half-to-even, as ``jnp.round`` does."""
    H, W = img.shape[:2]
    dev = img.device
    vs = (torch.arange(new_h, dtype=torch.float32, device=dev) + 0.5) * (H / new_h) - 0.5
    us = (torch.arange(new_w, dtype=torch.float32, device=dev) + 0.5) * (W / new_w) - 0.5
    vi = torch.clamp(torch.round(vs), 0, H - 1).to(torch.int64)
    ui = torch.clamp(torch.round(us), 0, W - 1).to(torch.int64)
    return img.index_select(0, vi).index_select(1, ui)


def resample_bilinear(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Bilinear resample for color/intensity images."""
    H, W = img.shape[:2]
    dev = img.device
    vs = (torch.arange(new_h, dtype=torch.float32, device=dev) + 0.5) * (H / new_h) - 0.5
    us = (torch.arange(new_w, dtype=torch.float32, device=dev) + 0.5) * (W / new_w) - 0.5
    v0 = torch.clamp(torch.floor(vs), 0, H - 1)
    u0 = torch.clamp(torch.floor(us), 0, W - 1)
    v0i = v0.to(torch.int64)
    u0i = u0.to(torch.int64)
    v1i = torch.clamp(v0i + 1, max=H - 1)
    u1i = torch.clamp(u0i + 1, max=W - 1)
    fv = torch.clamp(vs - v0, 0.0, 1.0)[:, None]
    fu = torch.clamp(us - u0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        fv = fv[..., None]
        fu = fu[..., None]
    rows0 = img.index_select(0, v0i)
    rows1 = img.index_select(0, v1i)
    a = rows0.index_select(1, u0i)
    b = rows0.index_select(1, u1i)
    c = rows1.index_select(1, u0i)
    d = rows1.index_select(1, u1i)
    return (
        a * (1 - fv) * (1 - fu)
        + b * (1 - fv) * fu
        + c * fv * (1 - fu)
        + d * fv * fu
    )


@cache
def _luma(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # made once per device: a host constant would be a copy to the card per
    # call, and a captured frame graph reads it by address
    return torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=device)


def rgb_to_intensity(color: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] -> [H, W] luminance (0.299 / 0.587 / 0.114)."""
    return color @ _luma(color.dtype, color.device)


def erode_depth(depth: torch.Tensor, radius: int = 2, dist_thresh: float = 0.1,
                frac_req: float = 0.4) -> torch.Tensor:
    """Invalidate depth pixels whose (2r+1)^2 neighborhood disagrees
    (reference ``erodeDepthMap``); neighbours wrap around like ``jnp.roll``."""
    valid = torch.isfinite(depth)
    d0 = torch.where(valid, depth, 0.0)
    thr = dist_thresh * torch.clamp(depth, min=1.0)
    # an invalid neighbour is nan in the window and fails the comparison
    dn = _wrapped_windows(torch.where(valid, depth, torch.nan), radius)
    cnt_ok = (torch.abs(dn - d0) < thr).sum(0)
    cnt_all = (2 * radius + 1) ** 2
    keep = valid & (cnt_ok.to(depth.dtype) >= frac_req * cnt_all)
    return torch.where(keep, depth, torch.nan)


def bilateral_filter_depth(depth: torch.Tensor, sigma_d: float = 2.0, sigma_r: float = 0.1,
                           radius: int | None = None) -> torch.Tensor:
    """Edge-preserving depth smoothing (reference ``gaussFilterDepthMap``):
    spatial gaussian x range gaussian, invalid neighbours excluded, output
    invalid where the center is invalid."""
    if radius is None:
        radius = int(2 * sigma_d)
    valid = torch.isfinite(depth)
    d0 = torch.where(valid, depth, 0.0)
    dn = _wrapped_windows(d0, radius)
    vn = _wrapped_windows(valid.to(depth.dtype), radius)
    off = torch.arange(-radius, radius + 1, dtype=torch.float32, device=depth.device)
    w_s = torch.exp(-(off[None, :] ** 2 + off[:, None] ** 2) / (2.0 * sigma_d * sigma_d))
    w_r = torch.exp(-((dn - d0) ** 2) / (2.0 * sigma_r * sigma_r))
    w = w_s.reshape(-1, 1, 1) * w_r * vn
    wd = w * dn
    # summed tap by tap in the reference's order: a float32 sum of 25 terms
    # in another order moves the quotient by several ulps of a depth
    acc, wacc = wd[0], w[0]
    for k in range(1, w.shape[0]):
        acc = acc + wd[k]
        wacc = wacc + w[k]
    out = acc / torch.clamp(wacc, min=1e-12)
    return torch.where(valid & (wacc > 1e-12), out, torch.nan)


def gauss_filter(img: torch.Tensor, sigma: float = 2.5, radius: int | None = None) -> torch.Tensor:
    """Separable gaussian blur for intensity/color [H, W(, C)] (reference
    ``gaussFilterIntensity``): rows first, then columns, wrapping around."""
    if radius is None:
        radius = int(2 * sigma)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / k.sum()
    a = img[None] if img.ndim == 2 else img.permute(2, 0, 1)       # [C, H, W]
    a = a[:, None]
    a = F.conv2d(F.pad(a, (0, 0, radius, radius), mode="circular"), k.reshape(1, 1, -1, 1))
    a = F.conv2d(F.pad(a, (radius, radius, 0, 0), mode="circular"), k.reshape(1, 1, 1, -1))
    a = a[:, 0]
    return a[0] if img.ndim == 2 else a.permute(1, 2, 0)


def compute_normals(cam_points: torch.Tensor) -> torch.Tensor:
    """Central-difference normals from camera-space points [H, W, 3]
    (reference ``computeNormals``). nan where neighbors invalid."""
    dx = torch.roll(cam_points, -1, 1) - torch.roll(cam_points, 1, 1)
    dy = torch.roll(cam_points, -1, 0) - torch.roll(cam_points, 1, 0)
    n = torch.linalg.cross(dy, dx, dim=-1)
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    ok = torch.isfinite(nn) & (nn > 1e-8)
    return torch.where(ok, n / torch.clamp(nn, min=1e-12), torch.nan)


def intensity_derivatives(intensity: torch.Tensor) -> torch.Tensor:
    """Sobel-style dI/du, dI/dv [H, W, 2] (reference
    ``computeIntensityDerivatives``)."""
    i = intensity

    def sobel(ax, other):
        d = torch.roll(i, -1, ax) - torch.roll(i, 1, ax)
        return (d * 2.0 + torch.roll(d, 1, other) + torch.roll(d, -1, other)) * 0.125

    return torch.stack([sobel(1, 0), sobel(0, 1)], -1)


def depth_to_cam_points(depth: torch.Tensor, intr: CameraIntrinsics) -> torch.Tensor:
    """Alias of ``geometry.camera.unproject`` for parity with
    ``convertDepthFloatToCameraSpaceFloat4``."""
    return unproject(depth, intr)


def reproject_depth_to_color(depth: torch.Tensor, intr_depth: CameraIntrinsics,
                             intr_color: CameraIntrinsics, depth_to_color: torch.Tensor,
                             fill_passes: int = 1) -> torch.Tensor:
    """Re-render a depth map [Hd, Wd] into the color camera's frame
    (``CUDAImageCalibrator`` analog): unproject, transform by the 4x4
    depth-to-color extrinsics, z-buffer with one packed scatter-min
    (quantized depth | source index), then fill sub-pixel holes with 3x3
    valid-neighbour passes. Returns [Hc, Wc] (nan = no sample)."""
    Hc, Wc = intr_color.height, intr_color.width
    pts = unproject(depth, intr_depth)
    fin = torch.isfinite(pts).all(-1)
    p = torch.where(fin[..., None], pts, 0.0).reshape(-1, 3)
    q = p @ depth_to_color[:3, :3].T + depth_to_color[:3, 3]
    z = q[:, 2]
    ok = fin.reshape(-1) & (z > 1e-3)
    zs = torch.clamp(z, min=1e-6)
    u = torch.round(q[:, 0] / zs * intr_color.fx + intr_color.cx).to(torch.int64)
    v = torch.round(q[:, 1] / zs * intr_color.fy + intr_color.cy).to(torch.int64)
    ok = ok & (u >= 0) & (u < Wc) & (v >= 0) & (v < Hc)
    pix = torch.where(ok, v * Wc + u, Hc * Wc)    # misses land in a spare last cell
    M = p.shape[0]
    # 19 index bits must cover every depth pixel (else winners alias)
    if M > 1 << 19:
        raise ValueError(f"depth map too large for packed z-buffer: {M}")
    # 12 bits of depth scaled to the live range; capped at 4094 so a packed
    # word never collides with the 2^31-1 miss sentinel
    miss = 2**31 - 1
    zmax = torch.clamp(torch.where(ok, z, 0.0).max(), min=1e-3)
    zq = torch.clamp((z / zmax * 4094.0).to(torch.int32), 0, 4094)
    idx = torch.arange(M, dtype=torch.int32, device=depth.device)
    packed = torch.where(ok, (zq << 19) | idx, miss)
    zbuf = torch.full((Hc * Wc + 1,), miss, dtype=torch.int32, device=depth.device)
    zbuf = zbuf.scatter_reduce(0, pix, packed, "amin")[: Hc * Wc]
    hit = zbuf != miss
    winner = torch.clamp(zbuf & ((1 << 19) - 1), 0, M - 1).to(torch.int64)
    out = torch.where(hit, z[winner], torch.nan).reshape(Hc, Wc)

    for _ in range(fill_passes):
        dn = _wrapped_windows(torch.where(torch.isfinite(out), out, torch.inf), 1)
        best = torch.cat([dn[:4], dn[5:]]).min(0).values
        out = torch.where(~torch.isfinite(out) & torch.isfinite(best), best, out)
    return out
