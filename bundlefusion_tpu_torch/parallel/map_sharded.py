"""TSDF map sharding over the ranks of a mesh.

Port of ``bundlefusion_tpu/parallel/map_sharded.py`` onto
``torch.distributed`` (``parallel/mesh.py``). The design is the JAX
module's:

- **payload rows shard by slot range**: rank k holds rows
  ``[k N/n, (k+1) N/n)`` of ``sdf``, ``weight``, ``color``, ``slot_keys`` and
  ``slot_geo``, plus the dummy row. Integration and de-integration are
  row-independent given a row's packed block key, so each rank applies an
  op batch to its rows with no collective; the only shared input is the
  replicated frame, which is the frustum exchange (any rank's blocks may
  project anywhere in the image);
- **the key index and the free list stay replicated** (single-writer
  semantics): allocation is deterministic, so every rank derives the same
  index; only payload writes are sharded.

A rank's sharded table is a ``VoxelBlockTable`` whose payload tensors hold
its N/n rows and the dummy row, so it is itself a table of N/n blocks. On a
card the op runs the port's three CUDA kernels (image pass, cull, sweep) over
those rows; on the CPU the plain row core ``apply_tsdf_ops_rows`` runs, as
the JAX module runs the XLA row core.
"""

from __future__ import annotations

import dataclasses

import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.parallel.ba_sharded import shard_rows
from bundlefusion_tpu_torch.parallel.mesh import Mesh, all_gather
from bundlefusion_tpu_torch.tsdf.apply_ops import apply_tsdf_ops, apply_tsdf_ops_rows
from bundlefusion_tpu_torch.tsdf.integrate import TsdfParams
from bundlefusion_tpu_torch.tsdf.table import VoxelBlockTable

PAYLOAD = ("sdf", "weight", "color", "slot_keys", "slot_geo")


def shard_table_payload(table: VoxelBlockTable, mesh: Mesh) -> VoxelBlockTable:
    """This rank's share of a replicated table: its contiguous N/n payload
    rows followed by the dummy row (copies); the index structures are the
    table's own tensors."""
    N = table.num_blocks
    if N % mesh.size:
        raise ValueError(f"{N} payload rows do not split over {mesh.size} ranks")
    rows = {name: torch.cat([shard_rows(getattr(table, name)[:N], mesh),
                             getattr(table, name)[N:]])
            for name in PAYLOAD}
    return dataclasses.replace(table, **rows)


def make_sharded_apply(mesh: Mesh, num_blocks: int, intr: CameraIntrinsics, params: TsdfParams):
    """The sharded (de)integration step: each rank applies the op batch to
    its slot range of payload rows, in place. Returns ``apply(table,
    depths, colors, poses, signs, img_of_op) -> table`` for a table from
    :func:`shard_table_payload` (``signs`` / ``img_of_op`` host sequences or
    tensors, as ``apply_tsdf_ops`` takes them)."""
    if num_blocks % mesh.size:
        raise ValueError(f"{num_blocks} payload rows do not split over {mesh.size} ranks")
    Nl = num_blocks // mesh.size

    def apply(table: VoxelBlockTable, depths, colors, poses, signs, img_of_op):
        if table.num_blocks != Nl:
            raise ValueError(f"a shard of {table.num_blocks} rows, expected {Nl}")
        if table.sdf.is_cuda:
            # the three CUDA kernels over this rank's rows
            return apply_tsdf_ops(table, depths, colors, poses, signs, img_of_op, intr, params)
        sdf, w, col = apply_tsdf_ops_rows(
            table.slot_keys[:Nl], table.sdf[:Nl], table.weight[:Nl], table.color[:Nl],
            depths, colors, poses, signs, img_of_op, intr, params)
        table.sdf[:Nl] = sdf
        table.weight[:Nl] = w
        table.color[:Nl] = col
        return table

    return apply


def gather_payload(table: VoxelBlockTable, mesh: Mesh) -> dict:
    """The whole table's payload from the ranks' shards, replicated:
    {name: [N + 1, ...]} for ``sdf``, ``weight``, ``color``, ``slot_keys``
    and ``slot_geo`` (the dummy row last)."""
    Nl = table.num_blocks
    return {name: torch.cat([all_gather(mesh, getattr(table, name)[:Nl]),
                             getattr(table, name)[Nl:]])
            for name in PAYLOAD}
