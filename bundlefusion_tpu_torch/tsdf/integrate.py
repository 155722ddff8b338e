"""TSDF allocation, visible-block compaction and integrate/de-integrate.

Port of ``bundlefusion_tpu/tsdf/integrate.py:46-398``: candidate blocks
along each depth ray's truncation band (reference ``allocKernel``),
in-frustum block compaction (``compactifyHashAllInOneKernel``), and the
signed-weight integrate / de-integrate voxel update
(``integrateDepthMapKernel<deIntegrate>``).

``integrate`` / ``deintegrate`` go through the fused apply op
(:func:`bundlefusion_tpu_torch.tsdf.apply_ops.apply_tsdf_ops`), the same
update the engine runs: depth and colour are sampled in their bf16
quantisation there, where the reference's standalone XLA ``integrate``
samples the raw float32 images.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.lie import pose_inverse, transform_points
from bundlefusion_tpu_torch.tsdf.table import (
    BLOCK_SIZE,
    EMPTY_KEY,
    GRID_BITS,
    GRID_DIM,
    GRID_HALF,
    VoxelBlockTable,
    allocate,
    block_to_world,
    unpack_key,
)


@dataclass(frozen=True)
class TsdfParams:
    voxel_size: float = 0.01
    truncation: float = 0.06
    truncation_scale: float = 0.02     # extra truncation per meter of depth
    max_integration_distance: float = 3.0
    integration_weight_sample: float = 1.0
    integration_weight_max: float = 99999999.0
    depth_min: float = 0.1
    depth_max: float = 4.0


def truncation_at(params: TsdfParams, depth):
    """Depth-dependent truncation band (reference ``getTruncation``)."""
    return params.truncation + params.truncation_scale * depth


def _ray_grid(depth, intr, params, stride):
    """Strided depth samples with their pixel coords and validity."""
    d = depth[::stride, ::stride]
    H, W = d.shape
    v = (torch.arange(H, dtype=torch.float32, device=d.device) * stride)[:, None]
    u = (torch.arange(W, dtype=torch.float32, device=d.device) * stride)[None, :]
    valid = torch.isfinite(d) & (d >= params.depth_min) & (
        d <= min(params.depth_max, params.max_integration_distance)
    )
    return d, u, v, valid


def _band_offsets(samples_per_ray, device):
    return torch.linspace(-1.0, 1.0, samples_per_ray, dtype=torch.float32, device=device)


def candidate_blocks(depth, intr: CameraIntrinsics, cam_to_world, params: TsdfParams,
                     samples_per_ray: int = 5, stride: int = 4):
    """Candidate block coords along each pixel ray within the truncation
    band. Returns (coords [M, 3] int32, valid [M] bool)."""
    d, u, v, valid = _ray_grid(depth, intr, params, stride)
    H, W = d.shape
    u = u.expand(H, W)
    v = v.expand(H, W)
    dirs = torch.stack(
        [(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, torch.ones_like(d)], -1
    )
    trunc = truncation_at(params, d)
    ts = _band_offsets(samples_per_ray, d.device)
    zs = d[None] + ts[:, None, None] * trunc[None]
    pts_cam = dirs[None] * zs[..., None]
    pts_world = transform_points(cam_to_world, pts_cam)
    vox = torch.floor(pts_world / params.voxel_size).to(torch.int32)
    block = torch.div(vox, BLOCK_SIZE, rounding_mode="floor")
    m = valid[None].expand(samples_per_ray, H, W) & (zs > 0)
    return block.reshape(-1, 3), m.reshape(-1)


def allocate_for_frame(table: VoxelBlockTable, depth, intr: CameraIntrinsics,
                       cam_to_world, params: TsdfParams) -> VoxelBlockTable:
    coords, valid = candidate_blocks(depth, intr, cam_to_world, params)
    return allocate(table, coords, valid)


def candidate_keys(depth, intr: CameraIntrinsics, cam_to_world, params: TsdfParams,
                   samples_per_ray: int = 5, stride: int = 4) -> torch.Tensor:
    """Packed candidate block keys [M] int32 along each ray's truncation
    band (EMPTY_KEY where invalid); duplicates arrive in runs, ready for
    the run-dedup in ``allocate_packed``."""
    d, u, v, valid = _ray_grid(depth, intr, params, stride)
    dirx = (u - intr.cx) / intr.fx
    diry = (v - intr.cy) / intr.fy
    trunc = truncation_at(params, d)
    ts = _band_offsets(samples_per_ray, d.device)
    zs = d[None] + ts[:, None, None] * trunc[None]          # [S, H, W]
    inv_b = 1.0 / (BLOCK_SIZE * params.voxel_size)
    R, t = cam_to_world[:3, :3], cam_to_world[:3, 3]
    wx = (R[0, 0] * dirx + R[0, 1] * diry + R[0, 2]) * zs + t[0]
    wy = (R[1, 0] * dirx + R[1, 1] * diry + R[1, 2]) * zs + t[1]
    wz = (R[2, 0] * dirx + R[2, 1] * diry + R[2, 2]) * zs + t[2]
    lim = GRID_DIM - 1

    def block_index(w):
        # clamp before the int conversion (out-of-range floats have no
        # defined int32 value); the clamped values still fail the range test
        b = torch.clamp(torch.floor(w * inv_b), -2.0 * GRID_DIM, 2.0 * GRID_DIM)
        return b.to(torch.int32) + GRID_HALF

    bx, by, bz = block_index(wx), block_index(wy), block_index(wz)
    in_range = (
        (bx >= 0) & (bx <= lim) & (by >= 0) & (by <= lim) & (bz >= 0) & (bz <= lim)
    )
    packed = (bz << (2 * GRID_BITS)) | (by << GRID_BITS) | bx
    ok = valid[None] & (zs > 0) & in_range
    return torch.where(ok, packed, EMPTY_KEY).to(torch.int32).reshape(-1)


def visible_block_indices(table: VoxelBlockTable, intr: CameraIntrinsics, cam_to_world,
                          params: TsdfParams, cap: int, margin_blocks: float = 1.0):
    """Compact list of key-table positions whose block intersects the
    frustum. Returns (positions [cap] int32 with -1 padding, count)."""
    world_to_cam = pose_inverse(cam_to_world)
    coords = unpack_key(table.keys)
    centers = block_to_world(coords, params.voxel_size) + 0.5 * BLOCK_SIZE * params.voxel_size
    c_cam = transform_points(world_to_cam, centers)
    z = c_cam[..., 2]
    pad = margin_blocks * BLOCK_SIZE * params.voxel_size
    zs = torch.clamp(z, min=1e-6)
    u = c_cam[..., 0] / zs * intr.fx + intr.cx
    v = c_cam[..., 1] / zs * intr.fy + intr.cy
    pad_px_u = pad * intr.fx / zs
    pad_px_v = pad * intr.fy / zs
    vis = (
        (table.keys != EMPTY_KEY)
        & (z > params.depth_min - pad)
        & (z < params.depth_max + pad)
        & (u >= -pad_px_u)
        & (u <= intr.width - 1 + pad_px_u)
        & (v >= -pad_px_v)
        & (v <= intr.height - 1 + pad_px_v)
    )
    pos = torch.cumsum(vis.to(torch.int64), 0) - 1
    out = torch.full((cap + 1,), -1, dtype=torch.int32, device=table.device)
    out[torch.where(vis & (pos < cap), pos, cap)] = torch.arange(
        table.capacity, dtype=torch.int32, device=table.device
    )
    count = torch.clamp(torch.sum(vis.to(torch.int32)), max=cap)
    return out[:cap], count


def _apply_one(table, depth, color, cam_to_world, intr, params, sign):
    from bundlefusion_tpu_torch.tsdf.apply_ops import apply_tsdf_ops

    return apply_tsdf_ops(table, depth[None], color[None], cam_to_world[None],
                          [sign], [0], intr, params)


def integrate(table: VoxelBlockTable, depth, color, intr: CameraIntrinsics,
              cam_to_world, params: TsdfParams) -> VoxelBlockTable:
    """Allocate the frame's blocks, then fuse it (sign +1), in place."""
    table = allocate_for_frame(table, depth, intr, cam_to_world, params)
    return _apply_one(table, depth, color, cam_to_world, intr, params, 1.0)


def deintegrate(table: VoxelBlockTable, depth, color, intr: CameraIntrinsics,
                cam_to_world, params: TsdfParams) -> VoxelBlockTable:
    """Remove a previously integrated frame (sign -1, no allocation;
    weights clamp at zero), in place."""
    return _apply_one(table, depth, color, cam_to_world, intr, params, -1.0)
