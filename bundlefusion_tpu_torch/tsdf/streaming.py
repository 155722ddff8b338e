"""Device <-> host paging of cold TSDF blocks (chunk-grid analog).

Port of ``bundlefusion_tpu/tsdf/streaming.py``. The reference pages voxel
blocks outside an active radius to host RAM (``CUDASceneRepChunkGrid``);
with the sorted-key table that is a bulk set operation:

- ``stream_out``: select blocks beyond ``radius`` of the camera, copy their
  payload rows to the host, free them from the table;
- ``stream_in``: re-insert paged blocks that re-entered the radius and
  restore their payloads.

Host storage is a dict keyed by packed block coordinates, one payload row
each (sdf [512], weight [512], colour [1536] in the table's r | g | b
layout). A re-integration over a paged region must ``stream_in`` first (the
reference's ``isSDFBlockStreamedOut`` check in the alloc kernel).

Block selection runs on the host in float64 over the key array, as the
reference's does, so both pick the same blocks. ``stream_out`` gathers the
selected rows on the device and copies only those rows (the reference
copies the whole payload, 2.05 GB at full size, and indexes it on the
host); the values are the same. Every device -> host copy is a counted
read (``utils.read_host_numpy``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bundlefusion_tpu_torch.tsdf.table import (
    BLOCK_SIZE,
    BLOCK_VOLUME,
    EMPTY_KEY,
    FREE_COMPACT,
    VoxelBlockTable,
    allocate,
    free_blocks,
    lookup_packed,
    unpack_key,
)
from bundlefusion_tpu_torch.utils import read_host_numpy


def _coords(keys: np.ndarray) -> np.ndarray:
    """Packed keys -> int32 block coords [N, 3] (on the host)."""
    return unpack_key(torch.from_numpy(np.asarray(keys).astype(np.int32))).numpy()


class HostBlockStore:
    """Host-side paged block storage (the ChunkDesc vectors analog)."""

    def __init__(self):
        self.blocks: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.blocks)

    def insert(self, keys: np.ndarray, sdf: np.ndarray, weight: np.ndarray, color: np.ndarray):
        for i, k in enumerate(keys):
            self.blocks[int(k)] = (sdf[i].copy(), weight[i].copy(), color[i].copy())

    def take(self, keys):
        """Pop the given keys: (sdf [k, 512], weight [k, 512], colour
        [k, 1536])."""
        out = [self.blocks.pop(int(k)) for k in keys]
        if not out:
            return (
                np.zeros((0, BLOCK_VOLUME), np.float32),
                np.zeros((0, BLOCK_VOLUME), np.float32),
                np.zeros((0, 3 * BLOCK_VOLUME), np.float32),
            )
        return tuple(np.stack([o[i] for o in out]) for i in range(3))


def stream_out(
    table: VoxelBlockTable,
    store: HostBlockStore,
    camera_pos: np.ndarray,
    radius: float,
    voxel_size: float,
    max_blocks: int = 100000,
) -> VoxelBlockTable:
    """Page out blocks whose centre is farther than ``radius`` from the
    camera. Updates ``table`` in place (and returns it); payloads land in
    ``store``."""
    keys = read_host_numpy(table.keys)
    occ = keys != EMPTY_KEY
    centers = (_coords(keys) + 0.5) * (BLOCK_SIZE * voxel_size)
    dist = np.linalg.norm(centers - np.asarray(camera_pos), axis=-1)
    idx = np.nonzero(occ & (dist > radius))[0][:max_blocks]
    if len(idx) == 0:
        return table
    sel_keys = keys[idx]
    dev = table.device
    rows = table.slots[torch.as_tensor(idx, device=dev)].to(torch.int64)
    payload = read_host_numpy(torch.cat([table.sdf[rows], table.weight[rows],
                                         table.color[rows]], dim=1))
    store.insert(sel_keys, payload[:, :BLOCK_VOLUME], payload[:, BLOCK_VOLUME:2 * BLOCK_VOLUME],
                 payload[:, 2 * BLOCK_VOLUME:])
    # free in <= FREE_COMPACT batches: free_blocks zeroes only that many
    # freed payload rows per call, and the free list is LIFO, so a bigger
    # batch would leave stale payload on top of the list for allocate
    # (which assumes zeroed slots) to pop first. Key positions re-sort on
    # every free, so each batch finds its keys by value
    sel_dev = torch.as_tensor(sel_keys, device=dev)
    for start in range(0, len(sel_keys), FREE_COMPACT):
        free_blocks(table, torch.isin(table.keys, sel_dev[start:start + FREE_COMPACT]))
    return table


def stream_in(
    table: VoxelBlockTable,
    store: HostBlockStore,
    camera_pos: np.ndarray,
    radius: float,
    voxel_size: float,
    max_blocks: int = 100000,
) -> VoxelBlockTable:
    """Page in stored blocks that re-entered the radius."""
    if not store.blocks:
        return table
    keys = np.fromiter(store.blocks.keys(), np.int64)
    centers = (_coords(keys) + 0.5) * (BLOCK_SIZE * voxel_size)
    dist = np.linalg.norm(centers - np.asarray(camera_pos), axis=-1)
    return stream_in_keys(table, store, keys[dist <= radius][:max_blocks])


def stream_in_keys(table: VoxelBlockTable, store: HostBlockStore, keys) -> VoxelBlockTable:
    """Page in an explicit set of stored block keys (e.g. the blocks a
    pending re-integration op's frustum touches). Blocks that fail to
    allocate (free list exhausted) stay in the host store."""
    sel = np.asarray(keys, np.int64)
    if len(sel) == 0:
        return table
    sdf, weight, color = store.take(sel)
    dev = table.device
    coords = torch.as_tensor(_coords(sel), device=dev)
    allocate(table, coords, torch.ones(len(sel), dtype=torch.bool, device=dev))
    slots = read_host_numpy(lookup_packed(table, torch.as_tensor(sel.astype(np.int32),
                                                                 device=dev)))
    ok = slots >= 0
    if not ok.all():
        store.insert(sel[~ok], sdf[~ok], weight[~ok], color[~ok])
    if not ok.any():
        return table
    rows = torch.as_tensor(slots[ok].astype(np.int64), device=dev)
    payload = torch.as_tensor(np.concatenate([sdf[ok], weight[ok], color[ok]], axis=1),
                              device=dev)
    table.sdf[rows] = payload[:, :BLOCK_VOLUME]
    table.weight[rows] = payload[:, BLOCK_VOLUME:2 * BLOCK_VOLUME]
    table.color[rows] = payload[:, 2 * BLOCK_VOLUME:]
    return table


def paged_keys_in_frustum(
    store: HostBlockStore,
    poses,          # iterable of cam-to-world 4x4 (numpy)
    intr,
    params,
    H: int,
    W: int,
) -> np.ndarray:
    """Conservative host-side frustum test: paged block keys whose AABB
    could be touched by any of the given camera poses' integration updates
    (the 8-corner test of ``active_tile_indices``, on the host).

    The image test is the reference's ``u.max >= 0`` / ``u.min <= W - 1``
    (not the half-pixel-wider test of the port's block cull), so both
    packages page in the same blocks."""
    if not store.blocks:
        return np.zeros((0,), np.int64)
    keys = np.fromiter(store.blocks.keys(), np.int64)
    bs = BLOCK_SIZE * params.voxel_size
    corner = _coords(keys).astype(np.float32) * bs
    offs = np.asarray(
        [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], np.float32
    ) * bs
    pts = corner[:, None, :] + offs[None]                       # [N, 8, 3]
    dmax = min(params.depth_max, params.max_integration_distance)
    zmax = dmax + params.truncation + params.truncation_scale * dmax
    hit = np.zeros(len(keys), bool)
    for T in poses:
        w2c = np.linalg.inv(np.asarray(T, np.float64)).astype(np.float32)
        R, t = w2c[:3, :3], w2c[:3, 3]
        pc = pts @ R.T + t
        z = pc[..., 2]
        all_front = (z > 1e-3).all(axis=1)
        zs = np.maximum(z, 1e-3)
        u = pc[..., 0] / zs * intr.fx + intr.cx
        v = pc[..., 1] / zs * intr.fy + intr.cy
        inside = (
            (u.max(1) >= 0.0) & (u.min(1) <= W - 1)
            & (v.max(1) >= 0.0) & (v.min(1) <= H - 1)
            & (z.min(1) <= zmax)
        )
        straddle = (z > 0.0).any(axis=1) & ~all_front           # conservative
        hit |= np.where(all_front, inside, straddle)
    return keys[hit]
