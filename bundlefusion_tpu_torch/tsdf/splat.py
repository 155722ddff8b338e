"""Surface-splat renderer: the per-frame visualisation of the engine.

Port of ``bundlefusion_tpu/tsdf/splat.py:50-312``. Rasterise the surface
itself: frustum-cull blocks on the slot geometry, gather the visible
blocks' payload rows, find sub-voxel zero crossings along in-block voxel
runs oriented along the dominant view axis, project them and z-buffer with
one packed-key scatter-min (``scatter_reduce_(..., "amin")``, order-free and
so deterministic), then fill sub-pixel holes with two 3x3 passes.
Output contract: ``depth`` / ``points`` / ``normals`` (camera space) /
``color``, nan where there is no surface.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.lie import pose_inverse
from bundlefusion_tpu_torch.tsdf.integrate import TsdfParams
from bundlefusion_tpu_torch.tsdf.table import BLOCK_SIZE, BLOCK_VOLUME, VoxelBlockTable

_MISS = 2**31 - 1


@dataclass(frozen=True)
class SplatParams:
    depth_min: float = 0.1
    depth_max: float = 4.0
    visible_cap: int = 8192       # max blocks rasterized per frame
    fill_passes: int = 2          # 3x3 hole-fill iterations
    use_color: bool = True


def _walk_x(a):
    return a.reshape(a.shape[0], 64, 8)


def _walk_y(a):
    return a.reshape(a.shape[0], 8, 8, 8).permute(0, 1, 3, 2).reshape(a.shape[0], 64, 8)


def _walk_z(a):
    return a.reshape(a.shape[0], 8, 8, 8).permute(0, 2, 3, 1).reshape(a.shape[0], 64, 8)


def walk_orders(device) -> torch.Tensor:
    """[3, 512] int64: row ``a`` holds the block's voxel indices in the order
    ``_walk_x`` / ``_walk_y`` / ``_walk_z`` lay them out (64 runs of 8 along
    axis ``a``)."""
    lin = torch.arange(BLOCK_VOLUME, dtype=torch.int64, device=device)[None]
    return torch.stack([w(lin).reshape(BLOCK_VOLUME) for w in (_walk_x, _walk_y, _walk_z)])


def _gathered_walk(order: torch.Tensor):
    """The walk of one axis chosen on the device: ``order`` [512] from
    :func:`walk_orders`, picked by an index tensor. The reference's
    ``lax.switch`` over the three walks; a gather of the same values, so
    bit for bit what the walk gives, with no read of the axis on the host."""
    def walk(a):
        return a.index_select(1, order).reshape(a.shape[0], 64, 8)
    return walk


def _run_crossings(sdf, w, axis_reshape, extras=()):
    """First sub-voxel surface crossing along each 8-voxel run.

    Returns (valid [V, 64], frac [V, 64] in [0, 1], lin_lo [V, 64] linear
    voxel index of the crossing's low voxel, extras_lo tuple of [V, 64]).
    """
    V = sdf.shape[0]
    s = axis_reshape(sdf)
    ww = axis_reshape(w)
    lin = axis_reshape(
        torch.arange(BLOCK_VOLUME, dtype=torch.int64, device=sdf.device).expand(V, BLOCK_VOLUME)
    )
    obs = ww > 0
    pos0 = s[..., :-1] > 0
    pos1 = s[..., 1:] > 0
    cross = obs[..., :-1] & obs[..., 1:] & (pos0 != pos1)
    # first crossing along the run (argmax of a descending score, ties to
    # the first index as jnp.argmax does)
    order = torch.arange(7, 0, -1, dtype=torch.int64, device=sdf.device)
    score = torch.where(cross, order, 0)
    i = torch.argmax(score, dim=-1, keepdim=True)          # [V, 64, 1]
    valid = torch.gather(cross, -1, i)[..., 0]
    s0 = torch.gather(s[..., :-1], -1, i)[..., 0]
    s1 = torch.gather(s[..., 1:], -1, i)[..., 0]
    denom = s0 - s1
    alpha = torch.clamp(
        torch.where(torch.abs(denom) > 1e-12, s0 / denom, 0.5), 0.0, 1.0
    )
    lin_lo = torch.gather(lin[..., :-1], -1, i)[..., 0]
    extras_lo = tuple(
        torch.gather(axis_reshape(e)[..., :-1], -1, i)[..., 0] for e in extras
    )
    return valid, alpha, lin_lo, extras_lo


def splat_render(table: VoxelBlockTable, intr: CameraIntrinsics, cam_to_world,
                 tsdf_params: TsdfParams, params: SplatParams = SplatParams()):
    """Render the TSDF surface from a camera pose by splatting crossings."""
    H, W = intr.height, intr.width
    dev = table.device
    vs = tsdf_params.voxel_size
    bs = BLOCK_SIZE * vs
    cam_to_world = cam_to_world.to(device=dev, dtype=torch.float32)
    w2c = pose_inverse(cam_to_world)
    R, t = w2c[:3, :3], w2c[:3, 3]

    # ---- 1. frustum cull on slot geometry (block centres + radius) ----
    N = table.num_blocks
    geo = table.slot_geo[:N]
    centers = (geo[:, :3] + 0.5) * bs
    live = geo[:, 3] > 0.5
    c_cam = centers @ R.T + t
    rad = 0.87 * bs
    z = c_cam[:, 2]
    inz = (z + rad > params.depth_min) & (z - rad < params.depth_max)
    zs = torch.clamp(z, min=1e-6)
    u = c_cam[:, 0] / zs * intr.fx + intr.cx
    v = c_cam[:, 1] / zs * intr.fy + intr.cy
    mu = rad / zs * intr.fx
    mv = rad / zs * intr.fy
    vis = (
        live & inz & (z > -rad)
        & (u + mu >= 0) & (u - mu <= W - 1)
        & (v + mv >= 0) & (v - mv <= H - 1)
    )
    # first Vcap visible slots in slot order, padded with N (the dummy row)
    Vcap = params.visible_cap
    pos = torch.cumsum(vis.to(torch.int64), 0) - 1
    vis_idx = torch.full((Vcap + 1,), N, dtype=torch.int64, device=dev)
    vis_idx[torch.where(vis & (pos < Vcap), pos, Vcap)] = torch.arange(
        N, dtype=torch.int64, device=dev
    )
    vis_idx = vis_idx[:Vcap]
    vok = vis_idx < N
    slot = vis_idx

    # ---- 2. row-gather visible payload ----
    sdf = table.sdf[slot]
    wgt = table.weight[slot] * vok[:, None]
    geo_v = table.slot_geo[slot]
    if params.use_color:
        col_rows = table.color[slot]
        extras = (
            wgt,
            col_rows[:, :BLOCK_VOLUME],
            col_rows[:, BLOCK_VOLUME : 2 * BLOCK_VOLUME],
            col_rows[:, 2 * BLOCK_VOLUME :],
        )
    else:
        extras = ()

    # ---- 3. crossings along the dominant view axis, chosen on the device ----
    axis = torch.argmax(torch.abs(cam_to_world[:3, 2])).reshape(1)
    order = walk_orders(dev).index_select(0, axis)[0]
    valid, alpha_c, lin_lo, extras_lo = _run_crossings(sdf, wgt, _gathered_walk(order), extras)

    lx = (lin_lo % BLOCK_SIZE).to(torch.float32)
    ly = ((lin_lo // BLOCK_SIZE) % BLOCK_SIZE).to(torch.float32)
    lz = (lin_lo // (BLOCK_SIZE * BLOCK_SIZE)).to(torch.float32)
    step = torch.eye(3, dtype=torch.float32, device=dev).index_select(0, axis)[0]
    base = geo_v[:, :3, None] * bs                          # [Vcap, 3, 1]
    local = torch.stack([lx, ly, lz], 1)                    # [Vcap, 3, 64]
    off = local + 0.5 + step[None, :, None] * alpha_c[:, None, :]
    pw = base + off * vs                                    # [Vcap, 3, 64]

    # ---- 4. project + packed z-buffer scatter-min ----
    pc = torch.einsum("ij,vjs->vis", R, pw) + t[None, :, None]
    zc = pc[:, 2]
    zok = (zc > params.depth_min) & (zc < params.depth_max)
    zs2 = torch.clamp(zc, min=1e-6)
    uf = torch.round(pc[:, 0] / zs2 * intr.fx + intr.cx)
    vf = torch.round(pc[:, 1] / zs2 * intr.fy + intr.cy)
    ok = valid & zok & (uf >= 0) & (uf < W) & (vf >= 0) & (vf < H)
    uu = torch.clamp(uf, 0, W - 1).to(torch.int64)
    vv = torch.clamp(vf, 0, H - 1).to(torch.int64)
    pix = torch.where(ok, vv * W + uu, H * W)

    M = Vcap * 64
    if M > 1 << 19:
        raise ValueError(f"visible_cap too large for the packed z-buffer: {M}")
    # z quantised into 12 bits over [0, depth_max]; clamped as floats first
    # (only ok samples are kept, and their z lies inside the range)
    zq = torch.clamp(zc * (4094.0 / params.depth_max), -1.0, 4095.0).to(torch.int64)
    zq = torch.clamp(zq, 0, 4094)
    sidx = torch.arange(M, dtype=torch.int64, device=dev).reshape(Vcap, 64)
    packed = torch.where(ok, (zq << 19) | sidx, _MISS)
    zbuf = torch.full((H * W + 1,), _MISS, dtype=torch.int64, device=dev)
    zbuf.scatter_reduce_(0, pix.reshape(-1), packed.reshape(-1), "amin", include_self=True)
    zbuf = zbuf[: H * W]
    hit = zbuf != _MISS
    winner = torch.clamp(zbuf & ((1 << 19) - 1), 0, M - 1)

    zq_win = (zbuf >> 19).to(torch.float32) * (params.depth_max / 4094.0)
    depth = torch.where(hit, zq_win, torch.nan).reshape(H, W)
    if params.use_color:
        w_lo = torch.clamp(extras_lo[0], min=1e-12)
        r8 = torch.clamp(extras_lo[1] / w_lo, 0.0, 1.0) * 255.0
        g8 = torch.clamp(extras_lo[2] / w_lo, 0.0, 1.0) * 255.0
        b8 = torch.clamp(extras_lo[3] / w_lo, 0.0, 1.0) * 255.0
        rgb_packed = (
            (r8.to(torch.int32) << 16) | (g8.to(torch.int32) << 8) | b8.to(torch.int32)
        ).reshape(M)
        rgb_win = rgb_packed[winner]
        col = torch.stack(
            [(rgb_win >> 16) & 0xFF, (rgb_win >> 8) & 0xFF, rgb_win & 0xFF], -1
        ).to(torch.float32) / 255.0
        color = torch.where(hit[:, None], col, torch.nan).reshape(H, W, 3)
    else:
        color = torch.full((H, W, 3), torch.nan, dtype=torch.float32, device=dev)

    # ---- 5. hole fill: valid-neighbour min depth, 3x3 ----
    for _ in range(params.fill_passes):
        best = torch.full((H, W), torch.inf, dtype=torch.float32, device=dev)
        bc = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                dn = torch.roll(depth, (dy, dx), (0, 1))
                cn = torch.roll(color, (dy, dx), (0, 1))
                better = torch.isfinite(dn) & (dn < best)
                best = torch.where(better, dn, best)
                bc = torch.where(better[..., None], cn, bc)
        use = ~torch.isfinite(depth) & torch.isfinite(best)
        depth = torch.where(use, best, depth)
        color = torch.where(use[..., None], bc, color)

    # camera-space points + normals (same construction as the raycaster)
    vg = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    ug = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    dirs = torch.stack(
        [(ug - intr.cx) / intr.fx, (vg - intr.cy) / intr.fy, torch.ones_like(ug)], -1
    )
    okp = torch.isfinite(depth)
    pts_cam = dirs * depth[..., None]
    dzdx = 0.5 * (torch.roll(pts_cam, -1, 1) - torch.roll(pts_cam, 1, 1))
    dzdy = 0.5 * (torch.roll(pts_cam, -1, 0) - torch.roll(pts_cam, 1, 0))
    n = torch.linalg.cross(dzdy, dzdx, dim=-1)
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    normals = torch.where(nn > 1e-8, n / torch.clamp(nn, min=1e-12), torch.nan)
    return {
        "depth": torch.where(okp, depth, torch.nan),
        "points": torch.where(okp[..., None], pts_cam, torch.nan),
        "normals": normals,
        "color": color,
    }
