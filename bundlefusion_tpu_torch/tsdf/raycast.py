"""TSDF raycasting: rendered depth / normals / colour from the voxel map.

Port of ``bundlefusion_tpu/tsdf/raycast.py`` as torch ops. Reference:
``CUDARayCastSDF.cu``, a per-pixel ray march at ``rayIncrementFactor *
truncation`` steps, zero-crossing detection, bisection refinement and
trilinear SDF / colour interpolation (``RayCastSDFUtil.h:97-303``).

As in the JAX package, the block lookup is a dense local grid of slots
([D^3] int32) centred on the middle of the view frustum and built in one
scatter over the key table, so every march step indexes the grid directly.
The march is a fixed number of steps with per-pixel done masks. Step
positions are float32 tensors computed in the reference's order
(``depth_min + i * step``); divisors are float32 tensors, so a division
rounds as the reference's does on every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.tsdf.integrate import TsdfParams
from bundlefusion_tpu_torch.tsdf.table import (
    BLOCK_SIZE,
    BLOCK_VOLUME,
    EMPTY_KEY,
    VoxelBlockTable,
    color_at,
    unpack_key,
)


@dataclass(frozen=True)
class RaycastParams:
    ray_increment_factor: float = 0.8     # step = factor * truncation
    depth_min: float = 0.1
    depth_max: float = 4.0
    grid_dim: int = 0                     # local grid blocks per axis;
                                          # 0 = auto-size to the frustum
    refine_iters: int = 6                 # bisection refinement steps
    use_color: bool = True


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (a tensor passes through, so
    the march makes no host -> device copy per step)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32, device=device)


_CORNERS = [(dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


def auto_grid_dim(intr: CameraIntrinsics, tsdf_params: TsdfParams,
                  params: RaycastParams) -> int:
    """Blocks per axis of a grid that holds the whole frustum plus the
    truncation margin around its midpoint (the reference's auto-size)."""
    if params.grid_dim:
        return params.grid_dim
    xm = max(intr.cx, intr.width - intr.cx) / intr.fx * params.depth_max
    ym = max(intr.cy, intr.height - intr.cy) / intr.fy * params.depth_max
    zh = 0.5 * (params.depth_max - params.depth_min)
    r = math.sqrt(xm * xm + ym * ym + zh * zh) + tsdf_params.truncation
    be = BLOCK_SIZE * tsdf_params.voxel_size
    return 2 * (int(math.ceil(r / be)) + 1)


def build_local_grid(table: VoxelBlockTable, center_world: torch.Tensor, voxel_size: float,
                     grid_dim: int):
    """Dense [grid_dim^3] int32 block -> slot grid centred near
    ``center_world``. Returns (grid [D, D, D] int32 slots with -1 empty,
    origin_block [3] int32). Keys outside the grid go to a spill cell that
    is cut off; keys inside are unique, so the one scatter is
    deterministic."""
    dev = table.device
    D = grid_dim
    block_extent = _f32(BLOCK_SIZE * voxel_size, dev)
    center_block = torch.floor(center_world / block_extent).to(torch.int32)
    origin = center_block - D // 2
    coords = unpack_key(table.keys) - origin
    occ = table.keys != EMPTY_KEY
    inb = occ & torch.all((coords >= 0) & (coords < D), dim=-1)
    c = coords.to(torch.int64)
    lin = (c[:, 2] * D + c[:, 1]) * D + c[:, 0]
    lin = torch.where(inb, lin, D**3)
    grid = torch.full((D**3 + 1,), -1, dtype=torch.int32, device=dev)
    grid[lin] = torch.where(inb, table.slots, -1).to(torch.int32)
    return grid[:-1].reshape(D, D, D), origin


def _slot_and_voxel(grid, origin, table, vox, grid_dim):
    """Integer voxel coords [..., 3] -> (slot clamped into the payload,
    found mask, linear voxel index). Gathers clamp their indices, as JAX's
    do, so coordinates of unhit pixels (NaN converted) stay in range."""
    block = torch.div(vox, BLOCK_SIZE, rounding_mode="floor") - origin
    local = vox - (block + origin) * BLOCK_SIZE
    inb = torch.all((block >= 0) & (block < grid_dim), dim=-1)
    bc = torch.clamp(block, 0, grid_dim - 1).to(torch.int64)
    slot = grid[bc[..., 2], bc[..., 1], bc[..., 0]]
    slot = torch.where(inb, slot, -1)
    lin = (local[..., 2] * BLOCK_SIZE + local[..., 1]) * BLOCK_SIZE + local[..., 0]
    lin = torch.clamp(lin, 0, BLOCK_VOLUME - 1).to(torch.int64)
    ok = slot >= 0
    ss = torch.clamp(slot, 0, table.num_blocks - 1).to(torch.int64)
    return ss, ok, lin


def _sample_nearest(grid, origin, table, pts_world, voxel_size, grid_dim):
    """Nearest-voxel (sdf, weight) at world points [..., 3]."""
    vs = _f32(voxel_size, pts_world.device)
    vox = torch.floor(pts_world / vs).to(torch.int32)
    ss, ok, lin = _slot_and_voxel(grid, origin, table, vox, grid_dim)
    sdf = table.sdf[ss, lin]
    w = table.weight[ss, lin]
    return torch.where(ok, sdf, 0.0), torch.where(ok, w, 0.0)


def _sample_trilinear(grid, origin, table, pts_world, voxel_size, grid_dim, with_color):
    """Trilinear (sdf, weight_min, color) at world points [..., 3].

    ``weight_min`` is the smallest corner weight, used as validity (every
    corner must be observed, ``trilinearInterpolationSimpleFastFast``)."""
    dev = pts_world.device
    g = pts_world / _f32(voxel_size, dev) - 0.5  # voxel-centre grid
    base = torch.floor(g).to(torch.int32)
    frac = g - base.to(torch.float32)
    shape = pts_world.shape[:-1]
    sdf_acc = torch.zeros(shape, dtype=torch.float32, device=dev)
    wmin = torch.full(shape, torch.inf, dtype=torch.float32, device=dev)
    col_acc = torch.zeros(shape + (3,), dtype=torch.float32, device=dev) if with_color else None
    offsets = torch.tensor(_CORNERS, dtype=torch.int32, device=dev)
    for k, (dx, dy, dz) in enumerate(_CORNERS):
        corner = base + offsets[k]
        wgt = (
            (frac[..., 0] if dx else 1 - frac[..., 0])
            * (frac[..., 1] if dy else 1 - frac[..., 1])
            * (frac[..., 2] if dz else 1 - frac[..., 2])
        )
        ss, ok, lin = _slot_and_voxel(grid, origin, table, corner, grid_dim)
        s = torch.where(ok, table.sdf[ss, lin], 0.0)
        w = torch.where(ok, table.weight[ss, lin], 0.0)
        sdf_acc = sdf_acc + wgt * s
        wmin = torch.minimum(wmin, w)
        if with_color:
            c = torch.where(
                ok[..., None],
                color_at(table, ss, lin) / torch.clamp(w, min=1e-12)[..., None],
                0.0,
            )
            col_acc = col_acc + wgt[..., None] * c
    return sdf_acc, wmin, col_acc


@torch.no_grad()
def raycast(
    table: VoxelBlockTable,
    intr: CameraIntrinsics,
    cam_to_world,
    tsdf_params: TsdfParams,
    params: RaycastParams = RaycastParams(),
):
    """Render the TSDF from a camera pose (on the table's device).

    Returns dict with ``depth`` [H, W] (nan where no surface), ``points``
    [H, W, 3] camera-space, ``normals`` [H, W, 3] camera-space (nan
    invalid), ``color`` [H, W, 3].
    """
    dev = table.device
    H, W = intr.height, intr.width
    voxel_size = _f32(tsdf_params.voxel_size, dev)
    T = torch.as_tensor(cam_to_world, dtype=torch.float32, device=dev)
    cam_pos = T[:3, 3]
    grid_dim = auto_grid_dim(intr, tsdf_params, params)
    center = cam_pos + T[:3, 2] * (0.5 * (params.depth_min + params.depth_max))
    grid, origin = build_local_grid(table, center, tsdf_params.voxel_size, grid_dim)

    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    dirs_cam = torch.stack(
        [(u - intr.cx) / _f32(intr.fx, dev), (v - intr.cy) / _f32(intr.fy, dev),
         torch.ones_like(u)], -1)
    dirs_world = dirs_cam @ T[:3, :3].T

    step_f = params.ray_increment_factor * tsdf_params.truncation
    n_steps = int(math.ceil((params.depth_max - params.depth_min) / step_f)) + 1
    step = _f32(step_f, dev)
    depth_min = _f32(params.depth_min, dev)
    # t_i = depth_min + i * step, in float32 as the reference's loop has it
    ts = depth_min + torch.arange(n_steps, dtype=torch.float32, device=dev) * step

    t_hit = torch.full((H, W), torch.nan, dtype=torch.float32, device=dev)
    prev_sdf = torch.zeros((H, W), dtype=torch.float32, device=dev)
    prev_t = torch.zeros((H, W), dtype=torch.float32, device=dev)
    prev_ok = torch.zeros((H, W), dtype=torch.bool, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for i in range(n_steps):
        t = ts[i]
        pts = cam_pos + t * dirs_world
        sdf, w = _sample_nearest(grid, origin, table, pts, voxel_size, grid_dim)
        ok = w > 0
        crossing = prev_ok & ok & (prev_sdf > 0) & (sdf <= 0) & ~done
        # linear interpolation of the zero crossing
        denom = prev_sdf - sdf
        alpha = torch.where(torch.abs(denom) > 1e-12, prev_sdf / denom, 0.5)
        t_surf = prev_t + alpha * (t - prev_t)
        t_hit = torch.where(crossing, t_surf, t_hit)
        done = done | crossing
        prev_sdf, prev_t, prev_ok = sdf, t.expand(H, W), ok

    # bisection refinement with trilinear sdf
    lo = torch.where(done, t_hit - step, 0.0)
    hi = torch.where(done, t_hit + step, 0.0)
    lo = torch.maximum(lo, depth_min)
    for _ in range(params.refine_iters):
        mid = 0.5 * (lo + hi)
        pts = cam_pos + mid[..., None] * dirs_world
        sdf, wmin, _ = _sample_trilinear(grid, origin, table, pts, voxel_size, grid_dim, False)
        go_lo = (wmin > 0) & (sdf <= 0)
        hi = torch.where(go_lo, mid, hi)
        lo = torch.where(go_lo, lo, mid)
    t_final = torch.where(done, 0.5 * (lo + hi), torch.nan)

    pts_world = cam_pos + t_final[..., None] * dirs_world
    _, _, color = _sample_trilinear(grid, origin, table, pts_world, voxel_size, grid_dim,
                                    params.use_color)
    depth = t_final  # t parameterises z because dirs_cam has z = 1
    ok = done & torch.isfinite(depth)
    depth = torch.where(ok, depth, torch.nan)

    # camera-space points + normals from cross products of neighbours; the
    # reference's jnp.roll wraps at the image edge, and so does torch.roll
    pts_cam = dirs_cam * depth[..., None]
    dzdx = 0.5 * (torch.roll(pts_cam, -1, 1) - torch.roll(pts_cam, 1, 1))
    dzdy = 0.5 * (torch.roll(pts_cam, -1, 0) - torch.roll(pts_cam, 1, 0))
    n = torch.linalg.cross(dzdy, dzdx, dim=-1)
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    normals = torch.where(nn > 1e-8, n / torch.clamp(nn, min=1e-12), torch.nan)
    if params.use_color:
        color = torch.where(ok[..., None], torch.clamp(color, 0.0, 1.0), torch.nan)
    else:
        color = torch.full((H, W, 3), torch.nan, dtype=torch.float32, device=dev)
    return {
        "depth": depth,
        "points": torch.where(ok[..., None], pts_cam, torch.nan),
        "normals": normals,
        "color": color,
    }
