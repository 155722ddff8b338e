"""Fused multi-op TSDF integrate / de-integrate over the voxel-block table.

Port of ``bundlefusion_tpu/tsdf/apply_pallas.py:554-912``. One call applies
a batch of ops — (pose, sign, image) triples; a re-integration row is a
de-integration at the old pose followed by an integration at the new one —
sequentially per voxel, in array order. Sign 0 is a bitwise no-op.

- :func:`apply_tsdf_ops_rows` is the plain row-range core (twin of the
  reference's XLA ``apply_tsdf_ops_rows``): it updates an arbitrary set of
  payload rows given their packed block keys.
- :func:`apply_tsdf_ops_ref` is the plain full sweep over every payload
  row (twin of ``apply_tsdf_ops_xla``), the oracle of the kernel.
- :func:`pack_images` is the plain version of the image pass: one
  ``(d_q, r_q, g_q, b_q)`` sample per pixel and each image's largest depth.
- :func:`active_block_rows` is the per-block frustum cull (from
  ``active_tile_indices``, at block rather than 128-row tile granularity);
  besides the rows it gives, per row, the bit mask of the ops that can
  touch it.
- :func:`apply_tsdf_ops` is the engine's entry point. For a table on the
  card it launches three hand-written CUDA kernels on the current stream
  and reads nothing back: ``kernels/tsdf_prepare.cu`` (image pass),
  ``kernels/tsdf_cull.cu`` (cull into a device-side row list) and
  ``kernels/tsdf_apply.cu`` (the sweep, replacing the Pallas
  ``_apply_kernel``). For a table on the CPU it runs
  :func:`apply_tsdf_ops_ref`.

All of them update the table's payload tensors **in place** (the JAX
functions return a new table).

Sampling matches the reference bit for bit: depth is sampled as
``bf16(d) + bf16(d - bf16(d))`` and colour as ``bf16(c)``, both pre-
quantised once per call (non-finite values and |x| >= 1e30 become 0), and
pixel coordinates round half-to-even.
"""

from __future__ import annotations

from typing import Optional

import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.lie import pose_inverse
from bundlefusion_tpu_torch.kernels import MAX_OPS  # ops per call: one mask bit each
from bundlefusion_tpu_torch.tsdf.integrate import TsdfParams
from bundlefusion_tpu_torch.tsdf.table import (
    BLOCK_SIZE,
    BLOCK_VOLUME,
    EMPTY_KEY,
    GRID_BITS,
    GRID_DIM,
    GRID_HALF,
    VoxelBlockTable,
    unpack_key,
)

V = BLOCK_VOLUME
REF_CHUNK_ROWS = 16384  # rows per step of the plain sweep (bounds its memory)


def quantize_images(depths: torch.Tensor, colors: torch.Tensor):
    """[IMGS, H, W] depth and [IMGS, H, W, 3] colour -> the f32 values the
    update samples: depth as bf16 hi + bf16 lo, colour rounded to bf16
    (round-to-nearest-even), non-finite and |x| >= 1e30 as 0."""

    def _fin(x):
        return torch.where(torch.isfinite(x) & (torch.abs(x) < 1e30), x, 0.0)

    d_f = _fin(depths)
    d_hi = d_f.to(torch.bfloat16)
    d_lo = (d_f - d_hi.to(torch.float32)).to(torch.bfloat16)
    d_q = d_hi.to(torch.float32) + d_lo.to(torch.float32)
    c_q = _fin(colors).to(torch.bfloat16).to(torch.float32)
    return d_q, c_q


def pack_images(depths: torch.Tensor, colors: torch.Tensor):
    """Plain version of the image pass (``kernels/tsdf_prepare.cu``): the
    quantised samples as one ``(d_q, r_q, g_q, b_q)`` per pixel,
    [IMGS, H, W, 4] f32, and each image's largest sampled depth [IMGS]
    (0 for an image with no positive depth), the cull's far bound."""
    d_q, c_q = quantize_images(depths, colors)
    packed = torch.cat([d_q[..., None], c_q], dim=-1).contiguous()
    img_dmax = torch.clamp(torch.amax(d_q.reshape(d_q.shape[0], -1), dim=1), min=0.0)
    return packed, img_dmax


def _op_vector(x, dtype, device):
    """(the values as a 1-d tensor on ``device``, their host copy to validate
    or None for a tensor that is on ``device`` already and is not read)."""
    if isinstance(x, torch.Tensor) and x.device.type == device.type:
        return x.to(device=device, dtype=dtype).reshape(-1), None
    host = torch.as_tensor(x, dtype=dtype).cpu().reshape(-1)
    if device.type == "cuda":
        # pinned and non-blocking: the copy is enqueued, nothing waits
        return host.pin_memory().to(device, non_blocking=True), host
    return host, host


def op_table(signs, img_of_op, n_ops: int, n_imgs: int, device):
    """The op table as the kernels read it: per-op signs float32 [OPS] and
    image indices int32 [OPS], on ``device``. Tensors on ``device`` pass
    through unread (an op whose image index is out of range is skipped, on
    the card and in the plain versions alike); anything else (sequences,
    numpy arrays, tensors on another device) is validated on the host and
    copied."""
    device = torch.device(device)
    signs, _ = _op_vector(signs, torch.float32, device)
    imgs, imgs_h = _op_vector(img_of_op, torch.int32, device)
    if signs.shape[0] != n_ops or imgs.shape[0] != n_ops:
        raise ValueError(f"{n_ops} poses but {signs.shape[0]} signs and {imgs.shape[0]} "
                         f"image indices")
    if imgs_h is not None and bool(((imgs_h < 0) | (imgs_h >= n_imgs)).any()):
        raise ValueError(f"img_of_op {imgs_h.tolist()} out of range for {n_imgs} images")
    return signs, imgs


def world_to_camera_rows(poses: torch.Tensor) -> torch.Tensor:
    """Cam-to-world poses [OPS, 4, 4] -> rows 0-2 of their inverses,
    [OPS, 3, 4] contiguous: the values of ``pose_inverse`` without its
    constant bottom row, which the kernels do not read (and in half as
    many small device ops)."""
    Rt = poses[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ poses[..., :3, 3][..., None])
    return torch.cat([Rt, ti], dim=-1)


def _voxel_centers(key: torch.Tensor, params: TsdfParams):
    """Packed block keys [R] -> per-axis voxel-centre world coords [R, V]
    and the live mask [R]."""
    live = key != EMPTY_KEY
    kx = ((key & (GRID_DIM - 1)) - GRID_HALF).to(torch.float32)
    ky = (((key >> GRID_BITS) & (GRID_DIM - 1)) - GRID_HALF).to(torch.float32)
    kz = (((key >> (2 * GRID_BITS)) & (GRID_DIM - 1)) - GRID_HALF).to(torch.float32)
    lin = torch.arange(V, dtype=torch.int32, device=key.device)
    lx = (lin % BLOCK_SIZE).to(torch.float32)
    ly = ((lin // BLOCK_SIZE) % BLOCK_SIZE).to(torch.float32)
    lz = (lin // (BLOCK_SIZE * BLOCK_SIZE)).to(torch.float32)
    bs = BLOCK_SIZE * params.voxel_size
    wx = kx[:, None] * bs + (lx[None] + 0.5) * params.voxel_size
    wy = ky[:, None] * bs + (ly[None] + 0.5) * params.voxel_size
    wz = kz[:, None] * bs + (lz[None] + 0.5) * params.voxel_size
    return wx, wy, wz, live


def _rows_update(key, sdf, w, col, d_q, c_q, w2c, signs, img_of_op,
                 intr: CameraIntrinsics, params: TsdfParams, op_mask=None):
    """The update rule over rows, on pre-quantised images and world-to-camera
    matrices; ``signs`` / ``img_of_op`` the op table as tensors [OPS] on the
    rows' device (read there: an op whose image index is out of range is
    skipped). ``op_mask`` [R, OPS] bool, if given, closes the update gate
    of op o on every row r with ``op_mask[r, o]`` false. Returns new
    (sdf, weight, color) rows."""
    wx, wy, wz, live = _voxel_centers(key, params)
    IMGS, H, W = d_q.shape
    dmax = min(params.depth_max, params.max_integration_distance)
    d_flat = d_q.reshape(IMGS, H * W)
    c_flat = c_q.reshape(IMGS, H * W, 3)
    img_ok = (img_of_op >= 0) & (img_of_op < IMGS)
    signs = torch.where(img_ok, signs, 0.0)
    imgs = torch.clamp(img_of_op, 0, IMGS - 1).to(torch.int64)
    for o in range(w2c.shape[0]):
        R, tr = w2c[o, :3, :3], w2c[o, :3, 3]
        sign = signs[o]
        img = imgs[o:o + 1]  # the image is picked on the device
        px = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + tr[0]
        py = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + tr[1]
        z = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + tr[2]
        zs = torch.clamp(z, min=1e-6)
        # bounds are tested on the rounded floats: equal to the reference's
        # int test in range, and free of float->int overflow out of it
        uf = torch.round(px / zs * intr.fx + intr.cx)
        vf = torch.round(py / zs * intr.fy + intr.cy)
        inb = (uf >= 0) & (uf < W) & (vf >= 0) & (vf < H) & (z > 0)
        uc = torch.clamp(uf, 0, W - 1).to(torch.int64)
        vc = torch.clamp(vf, 0, H - 1).to(torch.int64)
        lin = vc * W + uc
        d = d_flat.index_select(0, img)[0][lin]
        rgb = c_flat.index_select(0, img)[0][lin]            # [R, V, 3]
        depth_ok = (d >= params.depth_min) & (d <= dmax)
        sd = d - z
        trunc = params.truncation + params.truncation_scale * d
        upd = inb & depth_ok & (sd > -trunc) & live[:, None]
        if op_mask is not None:
            upd = upd & op_mask[:, o, None]
        sd_cl = torch.minimum(sd, trunc)
        w_new = (upd.to(torch.float32) * params.integration_weight_sample) * sign
        new_w = torch.clamp(w + w_new, 0.0, params.integration_weight_max)
        applied = new_w - w
        sum_sdf = sdf * w + torch.where(upd, sd_cl, 0.0) * applied
        sdf = torch.where(
            applied != 0,
            torch.where(new_w > 0, sum_sdf / torch.clamp(new_w, min=1e-12), 0.0),
            sdf,
        )
        appc = torch.where(upd, applied, 0.0)
        rgb_cm = rgb.permute(0, 2, 1).reshape(rgb.shape[0], 3 * V)
        col = torch.clamp(col + rgb_cm * appc.repeat(1, 3), min=0.0)
        w = new_w
    return sdf, w, col


def apply_tsdf_ops_rows(key, sdf_rows, weight_rows, color_rows, depths, colors,
                        poses, signs, img_of_op, intr: CameraIntrinsics,
                        params: TsdfParams):
    """Plain row-range core: apply the op batch to arbitrary payload rows
    (each row independent given its packed block key). Takes the raw
    images and cam-to-world poses like the reference, and the op table as
    :func:`op_table` does; returns new (sdf, weight, color) rows."""
    signs, img_of_op = op_table(signs, img_of_op, poses.shape[0], depths.shape[0],
                                depths.device)
    d_q, c_q = quantize_images(depths, colors)
    return _rows_update(key, sdf_rows, weight_rows, color_rows, d_q, c_q,
                        pose_inverse(poses), signs, img_of_op, intr, params)


def apply_tsdf_ops_ref(table: VoxelBlockTable, depths, colors, poses, signs,
                       img_of_op, intr: CameraIntrinsics, params: TsdfParams
                       ) -> VoxelBlockTable:
    """Plain full sweep: the update rule over every payload row (live or
    not; dead rows and the dummy row stay untouched), in place. The oracle
    of the CUDA kernels and the CPU path of :func:`apply_tsdf_ops`; takes
    ``signs`` / ``img_of_op`` as :func:`op_table` does."""
    N = table.num_blocks
    signs, img_of_op = op_table(signs, img_of_op, poses.shape[0], depths.shape[0],
                                depths.device)
    d_q, c_q = quantize_images(depths, colors)
    w2c = pose_inverse(poses)
    for r0 in range(0, N, REF_CHUNK_ROWS):
        r1 = min(r0 + REF_CHUNK_ROWS, N)
        sdf, w, col = _rows_update(
            table.slot_keys[r0:r1], table.sdf[r0:r1], table.weight[r0:r1],
            table.color[r0:r1], d_q, c_q, w2c, signs, img_of_op, intr, params,
        )
        table.sdf[r0:r1] = sdf
        table.weight[r0:r1] = w
        table.color[r0:r1] = col
    return table


def active_block_rows(table: VoxelBlockTable, w2c, signs, intr: CameraIntrinsics,
                      params: TsdfParams, H: int, W: int, op_dmax=None):
    """Per-block frustum cull, the plain version of ``kernels/tsdf_cull.cu``.

    Returns ``(rows, masks)``: int32 indices of the live payload rows whose
    block any op with sign != 0 can touch, ascending, and per listed row an
    int64 whose bit o says that op o can touch it (at most 64 ops).

    A voxel updates only if its centre projects in bounds with z > 0 and z
    is within the truncation band of a valid depth. A block in front of
    the camera whose 8 corners all project outside the image (or lie
    beyond the op's far bound) holds no such voxel: every interior point
    projects inside the convex hull of the corners. Blocks straddling the
    camera plane are kept. The image test is widened by half a pixel on
    each side, because a centre at u in [-0.5, 0) still rounds to pixel 0
    (the reference's tile-level test, ``>= 0`` / ``<= W - 1``, hides that
    edge behind 128-row tiles). ``op_dmax`` [OPS], the largest sampled
    depth of each op's image, tightens the far bound.
    """
    dev = table.slot_keys.device
    OPS = w2c.shape[0]
    if OPS > MAX_OPS:
        raise ValueError(f"{OPS} ops: the op mask holds at most {MAX_OPS}")
    bs = BLOCK_SIZE * params.voxel_size
    key = table.slot_keys[:table.num_blocks]
    live_rows = torch.nonzero(key != EMPTY_KEY).reshape(-1)
    corner = unpack_key(key[live_rows]).to(torch.float32) * bs
    offs = torch.tensor(
        [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
        dtype=torch.float32, device=dev,
    ) * bs
    pts = corner[:, None, :] + offs[None]                   # [L, 8, 3]
    x, y, z_w = (pts[:, None, :, a] for a in range(3))      # [L, 1, 8]

    def cam(i):  # row i of w2c applied to the corners, [L, OPS, 8]
        r = w2c[None, :, i, :, None]
        return r[..., 0, :] * x + r[..., 1, :] * y + r[..., 2, :] * z_w + r[..., 3, :]

    dmax = min(params.depth_max, params.max_integration_distance)
    if op_dmax is None:
        dm = torch.full((OPS,), dmax, dtype=torch.float32, device=dev)
    else:
        dm = torch.clamp(torch.as_tensor(op_dmax, dtype=torch.float32, device=dev), max=dmax)
    zmax = dm + params.truncation + params.truncation_scale * dm
    z = cam(2)
    all_front = torch.all(z > 1e-3, dim=2)
    zs = torch.clamp(z, min=1e-3)
    u = cam(0) / zs * intr.fx + intr.cx
    v = cam(1) / zs * intr.fy + intr.cy
    inside = (
        (torch.amax(u, 2) >= -0.5) & (torch.amin(u, 2) <= W - 0.5)
        & (torch.amax(v, 2) >= -0.5) & (torch.amin(v, 2) <= H - 0.5)
        & (torch.amin(z, 2) <= zmax[None])
    )
    straddle = torch.any(z > 0.0, dim=2) & ~all_front
    active = torch.as_tensor(signs, dtype=torch.float32, device=dev) != 0
    touch = torch.where(all_front, inside, straddle) & active[None]    # [L, OPS]
    bits = touch.to(torch.int64) << torch.arange(OPS, dtype=torch.int64, device=dev)[None]
    masks = bits.sum(dim=1)
    listed = masks != 0
    return live_rows[listed].to(torch.int32), masks[listed]


def mask_bits(masks: torch.Tensor, n_ops: int) -> torch.Tensor:
    """int64 op masks [R] -> bool [R, OPS]."""
    shifts = torch.arange(n_ops, dtype=torch.int64, device=masks.device)
    return ((masks[:, None] >> shifts[None]) & 1).to(torch.bool)


def apply_tsdf_ops(table: VoxelBlockTable, depths, colors, poses, signs, img_of_op,
                   intr: CameraIntrinsics, params: TsdfParams,
                   rows_swept: Optional[torch.Tensor] = None) -> VoxelBlockTable:
    """Apply a batch of (de)integration ops in one in-place pass.

    Args:
      depths: [IMGS, H, W] f32 meters (non-finite = invalid).
      colors: [IMGS, H, W, 3] f32 in [0, 1].
      poses: [OPS, 4, 4] cam-to-world per op.
      signs: [OPS] +1 integrate, -1 de-integrate, 0 no-op.
      img_of_op: [OPS] index into depths / colors.

    ``signs`` and ``img_of_op`` are tensors on the table's device, read
    there and nowhere else (an op whose image index is out of range is
    skipped), or host values (sequences or CPU tensors), which are validated
    and copied to the device (:func:`op_table`).

    A table on the card launches the three CUDA kernels (image pass, cull,
    sweep) on the current stream, and raises if it cannot; nothing between
    entry and return waits for the device, so the op can be captured in a
    CUDA graph (with the op table on the card). A table on the CPU runs the
    plain full sweep.

    ``rows_swept``, an int64 [1] tensor on the table's device, gets the
    number of rows the cull listed for the sweep added to it on the device
    (one more node in a captured graph, no read); the CPU's full sweep lists
    no rows and adds nothing.
    """
    if not table.sdf.is_cuda:
        return apply_tsdf_ops_ref(table, depths, colors, poses, signs, img_of_op,
                                  intr, params)
    from bundlefusion_tpu_torch.kernels import CUDA_STAGES

    return _apply_culled(table, depths, colors, poses, signs, img_of_op, intr,
                         params, CUDA_STAGES, rows_swept)


def _apply_culled(table, depths, colors, poses, signs, img_of_op, intr, params, stages,
                  rows_swept=None):
    """The culled path: image pass, cull, sweep. ``stages`` is the three
    launchers ``(prepare, cull, sweep)``: ``kernels.CUDA_STAGES``, or
    :data:`PLAIN_STAGES` at the same interfaces."""
    prepare, cull, sweep = stages
    OPS = poses.shape[0]
    IMGS, H, W = depths.shape
    signs, imgs = op_table(signs, img_of_op, OPS, IMGS, depths.device)
    if OPS > MAX_OPS:
        raise ValueError(f"{OPS} ops: the op mask holds at most {MAX_OPS}")
    w2c = world_to_camera_rows(poses.to(torch.float32))
    packed, img_dmax = prepare(depths.contiguous(), colors.contiguous())
    rows, masks, n_rows = cull(table, w2c, signs, imgs, img_dmax, intr, params, H, W)
    sweep(table, rows, masks, n_rows, packed, w2c, signs, imgs, intr, params)
    if rows_swept is not None:
        rows_swept += n_rows
    return table


def _cull_plain(table, w2c, signs, imgs, img_dmax, intr, params, H, W):
    """:func:`active_block_rows` at the cull launcher's interface: the row
    list, the masks and the number of listed rows as a tensor [1]. An op
    whose image index is out of range touches no row, as in the kernel."""
    n_imgs = img_dmax.shape[0]
    signs = torch.where((imgs >= 0) & (imgs < n_imgs), signs, 0.0)
    rows, masks = active_block_rows(table, w2c, signs, intr, params, H, W,
                                    op_dmax=img_dmax[torch.clamp(imgs, 0, n_imgs - 1).long()])
    n_rows = torch.tensor([rows.shape[0]], dtype=torch.int32, device=rows.device)
    return rows, masks, n_rows


def _launch_plain(table, rows, masks, n_rows, packed, w2c, signs, imgs, intr, params) -> None:
    """The sweep kernel's computation in plain PyTorch, at the launcher's
    interface: the update rule over the first ``n_rows`` listed rows, each
    op applied only to the rows whose mask holds its bit."""
    n = int(n_rows)
    r = rows[:n].long()
    sdf, w, col = _rows_update(
        table.slot_keys[r], table.sdf[r], table.weight[r], table.color[r],
        packed[..., 0], packed[..., 1:4], w2c, signs, imgs, intr, params,
        op_mask=mask_bits(masks[:n], signs.shape[0]),
    )
    table.sdf[r] = sdf
    table.weight[r] = w
    table.color[r] = col


PLAIN_STAGES = (pack_images, _cull_plain, _launch_plain)
