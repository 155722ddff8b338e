"""Dense depth (point-to-plane) + photometric BA term.

Port of ``bundlefusion_tpu/solver/dense_term.py``, the re-design of the
reference's ``BuildDenseSystem`` path (``Solver/SolverBundling.cu:308-471``):

1. ``find_overlapping_pairs``: candidate frame pairs whose cameras look in
   similar directions and whose subsampled projective overlap has enough
   hits (``FindImageImageCorr_Kernel``);
2. ``build_dense_system``: per pair and pixel the point-to-plane depth
   residual (+ the photometric residual with gradient gating) under
   projective association, with exact forward-mode Jacobians in the 12 pose
   parameters, reduced into per-pair [12, 12] / [12] blocks; pairs under
   ``min_corr_per_pair`` associations weigh nothing
   (``WeightDenseCorrespondences``);
3. ``dense_matvec`` / ``dense_rhs`` / ``dense_precond_blocks`` /
   ``dense_block_matrix``: the blocks applied to, or assembled into, the
   camera system.

Pairs are a fixed-capacity masked list. The per-pose sums over the pair list
are one-hot products (``utils.onehot_sum``), not scatter-adds with repeated
indices, so they repeat bit for bit on the card. Above 16384 frame pairs the
overlap test runs over the pairs that pass the cheap tests only (their
number is one device -> host read); the JAX module sweeps all N^2 in chunks
and masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.lie import pose_inverse, pose_to_matrix
from bundlefusion_tpu_torch.ops.resample import onehot_gather2d
from bundlefusion_tpu_torch.pipeline.frames import DenseCache
from bundlefusion_tpu_torch.utils import host_reads, onehot_sum

_PAIR_CHUNK = 16384


@dataclass(frozen=True)
class DenseTermParams:
    dist_thresh: float = 0.15          # s_denseDistThresh
    normal_thresh: float = 0.97        # s_denseNormalThresh
    color_thresh: float = 0.1          # s_denseColorThresh
    color_gradient_min: float = 0.005  # s_denseColorGradientMin
    depth_min: float = 0.5             # s_denseDepthMin
    depth_max: float = 4.0             # s_denseDepthMax
    overlap_subsample: int = 4         # s_denseOverlapCheckSubsampleFactor
    overlap_min_hits: int = 10         # FindImageImageCorr threshold
    min_corr_per_pair: int = 800       # WeightDenseCorrespondences zero-thresh
    angle_thresh: float = 0.52         # rad, view-angle gate
    max_pairs: int = 128               # fixed pair capacity


def _project(q, intr: CameraIntrinsics):
    z = q[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = q[..., 0] / zs * intr.fx + intr.cx
    v = q[..., 1] / zs * intr.fy + intr.cy
    inb = (u >= 0) & (u <= intr.width - 1) & (v >= 0) & (v <= intr.height - 1)
    return u, v, z, inb


def find_overlapping_pairs(poses, frame_valid, cache: DenseCache, intr: CameraIntrinsics,
                           p: DenseTermParams):
    """Candidate pair list [max_pairs, 2] + mask, from view-angle + coarse
    projective-overlap tests over all frame pairs in the domain, in
    row-major (i, j) order."""
    N = poses.shape[0]
    dev = poses.device
    mats = pose_to_matrix(poses)
    z_axes = mats[:, :3, 2]

    ar = torch.arange(N, device=dev)
    upper = ar[:, None] < ar[None, :]
    both_valid = frame_valid[:, None] & frame_valid[None, :]
    cos = (z_axes[:, None, :] * z_axes[None, :, :]).sum(-1)
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    cand = upper & both_valid & (ang < 2 * p.angle_thresh)

    # coarse overlap: project subsampled valid points of i into j
    sub = p.overlap_subsample
    pts = cache.campos[:, ::sub, ::sub]  # [N, h', w', 3]

    def overlap_count(fi, fj):
        T_ij = pose_inverse(mats[fj]) @ mats[fi]                          # [c, 4, 4]
        q = pts[fi] @ T_ij[:, None, :3, :3].transpose(-1, -2) + T_ij[:, None, None, :3, 3]
        _, _, z, inb = _project(q, intr)
        ok = torch.isfinite(q).all(-1) & (z > p.depth_min) & (z < p.depth_max) & inb
        return ok.sum((-1, -2))

    if N * N <= _PAIR_CHUNK:
        counts = overlap_count(ar.repeat_interleave(N), ar.repeat(N)).reshape(N, N)
    else:
        host_reads["count"] += 1
        idx = torch.nonzero(cand.reshape(-1))[:, 0]     # waits for the card
        counts = torch.zeros(N * N, dtype=torch.int64, device=dev)
        for s in range(0, idx.shape[0], _PAIR_CHUNK):
            part = idx[s:s + _PAIR_CHUNK]
            counts[part] = overlap_count(part // N, part % N)
        counts = counts.reshape(N, N)
    cand = cand & (counts >= p.overlap_min_hits)

    flat = cand.reshape(-1)
    first = torch.sort((~flat).to(torch.int8), stable=True).indices[:p.max_pairs]
    if first.shape[0] < p.max_pairs:
        first = torch.cat([first, first.new_zeros(p.max_pairs - first.shape[0])])
    mask = torch.arange(p.max_pairs, device=dev) < torch.clamp(flat.sum(), max=p.max_pairs)
    pairs = torch.stack([first // N, first % N], -1)
    return torch.where(mask[:, None], pairs, 0).to(torch.int32), mask


def _pair_residuals(pose_i, pose_j, campos_i, normal_i, inten_i,
                    campos_j, normal_j, inten_j, grad_j,
                    intr: CameraIntrinsics, p: DenseTermParams):
    """Masked per-pixel (depth_res, color_res, weight, valid, cvalid) for a
    batch of pairs: poses [P, 6], images [P, h, w(, c)].

    Projective association of frame i's points into frame j
    (``findDenseCorr``): r_depth = n_j . (T p_i - p_j_assoc), gated on
    distance + normal agreement; r_color = I_i - I_j(proj), gated on
    gradient magnitude.
    """
    # sanitize BEFORE any arithmetic: NaN inputs poison forward-mode
    # tangents even through torch.where
    fin_i = torch.isfinite(campos_i).all(-1) & torch.isfinite(normal_i).all(-1)
    campos_i = torch.where(fin_i[..., None], campos_i, 0.0)
    normal_i = torch.where(fin_i[..., None], normal_i, 0.0)
    fin_j_img = torch.isfinite(campos_j).all(-1) & torch.isfinite(normal_j).all(-1)
    campos_j = torch.where(fin_j_img[..., None], campos_j, 0.0)
    normal_j = torch.where(fin_j_img[..., None], normal_j, 0.0)

    T = pose_inverse(pose_to_matrix(pose_j)) @ pose_to_matrix(pose_i)     # [P, 4, 4]
    Rt = T[:, None, :3, :3].transpose(-1, -2)
    q = campos_i @ Rt + T[:, None, None, :3, 3]
    nq = normal_i @ Rt
    u, v, z, inb = _project(q, intr)
    inb = inb & (z > 0)
    ui = torch.clamp(torch.round(u), 0, intr.width - 1).to(torch.int64)
    vi = torch.clamp(torch.round(v), 0, intr.height - 1).to(torch.int64)
    # the samples are constants w.r.t. the poses within a GN iteration,
    # exactly like the reference's Jacobian
    stack_j = torch.cat(
        [
            campos_j.movedim(-1, 1),
            normal_j.movedim(-1, 1),
            inten_j[:, None],
            grad_j.movedim(-1, 1),
            fin_j_img[:, None].to(torch.float32),
        ],
        dim=1,
    )  # [P, 10, h, w]
    smp = onehot_gather2d(stack_j, vi, ui, inb)
    pt = smp[..., 0:3]
    nt = smp[..., 3:6]
    it_ = smp[..., 6]
    gt_ = smp[..., 7:9]
    fin_j = smp[..., 9] > 0.5
    d = torch.sqrt(((q - pt) ** 2).sum(-1) + 1e-18)
    dn = (nq * nt).sum(-1)
    valid = (
        inb & fin_i & fin_j
        & (z > p.depth_min) & (z < p.depth_max)
        & (d <= p.dist_thresh)
        & (dn >= p.normal_thresh)
    )
    r_depth = torch.where(valid, (nt * (q - pt)).sum(-1), 0.0)
    gmag = torch.linalg.norm(gt_, dim=-1)
    cvalid = valid & (gmag >= p.color_gradient_min)
    r_color = torch.where(cvalid, inten_i - it_, 0.0)
    # distance + depth falloff weight (reference weighted ICP style)
    zn = torch.clamp((z - p.depth_min) / (p.depth_max - p.depth_min), 0, 1)
    w = torch.where(
        valid, torch.clamp(0.5 * ((1.0 - d / p.dist_thresh) + (1.0 - zn)), min=0.0), 0.0)
    return r_depth, r_color, w, valid, cvalid


class DensePairSystem(NamedTuple):
    pairs: torch.Tensor      # [P, 2] int32
    mask: torch.Tensor       # [P] bool (pair active + enough corrs)
    H: torch.Tensor          # [P, 12, 12] JtJ blocks (ordered [pose_i, pose_j])
    b: torch.Tensor          # [P, 12] Jtr
    num_corr: torch.Tensor   # [P] int32


def build_dense_system(poses, pairs, pair_mask, cache: DenseCache, intr: CameraIntrinsics,
                       p: DenseTermParams = DenseTermParams(), w_depth: float = 1.0,
                       w_color: float = 0.0) -> DensePairSystem:
    """Per-pair reduced systems with exact forward-mode Jacobians."""
    inten = cache.intensity
    grad = torch.stack(
        [
            0.5 * (torch.roll(inten, -1, 2) - torch.roll(inten, 1, 2)),
            0.5 * (torch.roll(inten, -1, 1) - torch.roll(inten, 1, 1)),
        ],
        -1,
    )
    i = pairs[:, 0].to(torch.int64)
    j = pairs[:, 1].to(torch.int64)
    imgs = (cache.campos[i], cache.normal[i], inten[i],
            cache.campos[j], cache.normal[j], inten[j], grad[j])
    P = pairs.shape[0]
    sd, sc = math.sqrt(w_depth), math.sqrt(w_color) if w_color > 0 else 0.0

    def res_fn(pose_ij):
        rd, rc, w, valid, _ = _pair_residuals(pose_ij[:, :6], pose_ij[:, 6:], *imgs, intr, p)
        # weights are IRLS-style constants within a GN iteration (the
        # reference bakes them into the accumulators, not the Jacobian);
        # detaching also avoids the infinite derivative of sqrt at 0
        sw = torch.sqrt(torch.clamp(w, min=0.0)).detach()
        parts = [(rd * sw).reshape(P, -1) * sd]
        if w_color > 0:
            parts.append((rc * sw).reshape(P, -1) * sc)
        return torch.cat(parts, -1), valid

    pose_ij = torch.cat([poses[i], poses[j]], -1)                       # [P, 12]
    r, valid = res_fn(pose_ij)                                          # [P, R]
    basis = torch.eye(12, dtype=poses.dtype, device=poses.device)[:, None, :].expand(12, P, 12)
    # exact Jacobian [P, R, 12] by forward mode over the 12 basis tangents
    J = vmap(lambda t: jvp(lambda y: res_fn(y)[0], (pose_ij,), (t,))[1])(basis).permute(1, 2, 0)
    n_corr = valid.sum((-1, -2)).to(torch.int32)
    ok = pair_mask & (n_corr >= p.min_corr_per_pair)
    scale = ok.to(torch.float32)
    H = torch.einsum("pri,prj->pij", J, J) * scale[:, None, None]
    b = torch.einsum("pri,pr->pi", J, r) * scale[:, None]
    return DensePairSystem(pairs=pairs, mask=ok, H=H, b=b, num_corr=n_corr)


def _masked_ij(sys: DensePairSystem, num_frames: int):
    """Pose rows of the pairs, masked-out pairs pointing past the last row."""
    i = torch.where(sys.mask, sys.pairs[:, 0], num_frames).to(torch.int64)
    j = torch.where(sys.mask, sys.pairs[:, 1], num_frames).to(torch.int64)
    return i, j


def dense_matvec(sys: DensePairSystem, x, num_frames: int):
    """[N, 6] -> [N, 6]: apply the summed pair JtJ blocks."""
    i = torch.clamp(sys.pairs[:, 0], 0, num_frames - 1).to(torch.int64)
    j = torch.clamp(sys.pairs[:, 1], 0, num_frames - 1).to(torch.int64)
    xij = torch.cat([x[i], x[j]], -1)  # [P, 12]
    y = torch.einsum("pab,pb->pa", sys.H, xij)
    y = torch.where(sys.mask[:, None], y, 0.0)
    ii, jj = _masked_ij(sys, num_frames)
    return onehot_sum(y[:, :6], ii, num_frames) + onehot_sum(y[:, 6:], jj, num_frames)


def dense_rhs(sys: DensePairSystem, num_frames: int):
    """-Jtr contribution [N, 6]."""
    bb = torch.where(sys.mask[:, None], sys.b, 0.0)
    ii, jj = _masked_ij(sys, num_frames)
    return -(onehot_sum(bb[:, :6], ii, num_frames) + onehot_sum(bb[:, 6:], jj, num_frames))


def dense_precond_blocks(sys: DensePairSystem, num_frames: int):
    """Per-frame 6x6 diagonal blocks of the dense JtJ (for block-Jacobi)."""
    Hm = torch.where(sys.mask[:, None, None], sys.H, 0.0)
    ii, jj = _masked_ij(sys, num_frames)
    return (onehot_sum(Hm[:, :6, :6], ii, num_frames)
            + onehot_sum(Hm[:, 6:, 6:], jj, num_frames))


def dense_block_matrix(sys: DensePairSystem, num_frames: int):
    """Assemble the dense-term contribution as a full [N, N, 6, 6] block
    grid (for the direct reduced solve). A pair (i, j), i < j, is listed at
    most once, so its off-diagonal blocks are plain writes; masked-out pairs
    write zeros at (0, 0) before the diagonal sums are added."""
    N = num_frames
    Hm = torch.where(sys.mask[:, None, None], sys.H, 0.0)
    i = torch.where(sys.mask, sys.pairs[:, 0], 0).to(torch.int64)
    j = torch.where(sys.mask, sys.pairs[:, 1], 0).to(torch.int64)
    A = Hm.new_zeros((N, N, 6, 6))
    A[i, j] = Hm[:, :6, 6:]
    A[j, i] = Hm[:, 6:, :6]
    ar = torch.arange(N, device=A.device)
    A[ar, ar] = dense_precond_blocks(sys, N)
    return A
