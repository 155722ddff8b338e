"""Match-filter cascade: greedy Kabsch -> surface area -> dense verify.

Port of ``bundlefusion_tpu/ops/filters.py`` (the reference's
``FilterKeyPointMatchesCU``, ``FilterMatchesBySurfaceAreaCU`` and
``FilterMatchesByDenseVerifyCU``). The JAX stages are per-pair functions
``vmap``-ed over image pairs; here every stage takes a leading pair
dimension P and the ``*_pair`` forms are the P = 1 case.

The greedy Kabsch filter and the surface-area filter are hand kernels on
the card (``kernels/kabsch_filter.cu``, ``kernels/surface_area.cu``); the
wrappers ``kabsch_filter`` / ``surface_area_filter`` run their plain
versions (``*_ref``) on CPU tensors. The greedy Kabsch filter is two nested
data-dependent loops. On the card
``kabsch_filter`` launches ``kernels/kabsch_filter.cu``, which runs each
pair's loops in one warp, with every sum over the matches and a fit's 4x4
algebra spread over its lanes, and reads nothing back. Its plain version,
``kabsch_filter_ref``, is what runs on the CPU: as JAX does under ``vmap``,
it runs every pair until the last one has finished, with one loop over
candidate positions shared by all pairs, per-pair ``alive`` masks, and
updates applied with ``torch.where``. There the host decides when a loop
ends and whether a step needs a fit at all, so each such test is one small
device -> host read; both return their number as ``host_reads`` (0 for the
kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.kabsch import _horn_rotation, sym3_eigenvalues
from bundlefusion_tpu_torch.geometry.lie import _rt_to_mat, pose_inverse
from bundlefusion_tpu_torch.ops.resample import onehot_gather2d

PIXEL_DIST_THRESH = 5.0        # MATCH_FILTER_PIXEL_DIST_THRESH (cuda_kabsch.h:278)
CONDITION_THRESH = 100.0       # KABSCH_CONDITION_THRESH (cuda_kabsch.h:279)


# ---------------------------------------------------------------------------
# Stage 1: greedy Kabsch filter
# ---------------------------------------------------------------------------


def _weighted_cov(pts, w):
    """Weighted mean-centred covariance of [..., N, 3] points."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    mu = (pts * w[..., None]).sum(-2) / wsum
    c = pts - mu[..., None, :]
    return (c * w[..., None]).transpose(-1, -2) @ c / wsum[..., None]


def kabsch_filter(src_pts, tgt_pts, pix_src, pix_tgt, valid, max_filtered: int = 25,
                  min_num_matches: int = 4, max_res2: float = 4e-4):
    """Greedy geometric-consistency filter for P image pairs: the arguments
    and results of :func:`kabsch_filter_ref`.

    On CUDA tensors it launches ``kernels/kabsch_filter.cu`` once (none for
    P = 0) on the current stream, reads nothing back and returns
    ``host_reads`` 0; it raises if the kernel cannot be built or launched.
    On CPU tensors it runs :func:`kabsch_filter_ref`.
    """
    if not valid.is_cuda:
        return kabsch_filter_ref(src_pts, tgt_pts, pix_src, pix_tgt, valid, max_filtered,
                                 min_num_matches, max_res2)
    from bundlefusion_tpu_torch.kernels import kabsch_filter_launch

    inlier, count, transform, valid_pair = kabsch_filter_launch(
        *(x.contiguous() for x in (src_pts, tgt_pts, pix_src, pix_tgt, valid)),
        max_filtered, min_num_matches, max_res2)
    return {"inlier_mask": inlier, "count": count, "transform": transform,
            "valid_pair": valid_pair, "host_reads": 0}


def kabsch_filter_ref(src_pts, tgt_pts, pix_src, pix_tgt, valid, max_filtered: int = 25,
                      min_num_matches: int = 4, max_res2: float = 4e-4):
    """Greedy geometric-consistency filter for P image pairs, in torch ops:
    the plain version of ``kernels/kabsch_filter.cu``.

    Args:
      src_pts/tgt_pts: [P, R, 3] back-projected keypoint positions of the raw
        matches, sorted ascending by descriptor distance.
      pix_src/pix_tgt: [P, R, 2] pixel positions (for the 5 px dedup).
      valid: [P, R] raw-match validity. MUST be prefix-contiguous per pair
        (all True entries before the first False): the scan of a pair stops
        at its first invalid entry, like the reference's candidate loop.
        ``matching.py`` guarantees this (the sort puts invalid entries at
        the tail); any other caller must too.

    Reference semantics per candidate (cuda_kabschReference.h:458-496):
    skip it if it lies within 5 px of an inlier in either image; else add
    it and refit; while the max residual exceeds the bound, strip the worst
    inlier and refit, reverting the last removal if stripping down to 3 made
    things worse.

    Returns dict with ``inlier_mask`` [P, R], ``count`` [P], ``transform``
    [P, 4, 4] (src -> tgt), ``valid_pair`` [P], and ``host_reads``, the
    number of device -> host reads the call made (a host integer).
    """
    P, R = valid.shape
    dev = valid.device
    arange_r = torch.arange(R, device=dev)

    # what no step changes: finiteness, sanitised points (a zero weight must
    # not meet a nan: 0 * nan = nan) and which matches lie within 5 px of
    # which in either image
    fin_s = torch.isfinite(src_pts).all(-1)
    fin_t = torch.isfinite(tgt_pts).all(-1)
    src0 = torch.where(fin_s[..., None], src_pts, 0.0)
    tgt0 = torch.where(fin_t[..., None], tgt_pts, 0.0)
    both0 = torch.stack([src0, tgt0])
    fin_each = torch.stack([fin_s, fin_t]).to(torch.float32)
    fin_both = (fin_s & fin_t).to(torch.float32)
    near = (
        (torch.linalg.norm(pix_src[:, :, None] - pix_src[:, None], dim=-1) <= PIXEL_DIST_THRESH)
        | (torch.linalg.norm(pix_tgt[:, :, None] - pix_tgt[:, None], dim=-1) <= PIXEL_DIST_THRESH)
    )                                                           # [P, R(candidate), R]

    def residuals2(Rm, t):
        """Squared residuals [P, R] of src -> tgt under (R, t)."""
        return ((src_pts @ Rm.transpose(-1, -2) + t[:, None] - tgt_pts) ** 2).sum(-1)

    def geo(mask):
        """Fit + stats of the masked consensus: (R, t, maxres, cond_ok).
        The reference's ``kabsch_fast``, ``_cross_cov_cond`` (sigma1/sigma2
        of the cross-covariance, the reference's ``c1``) and ``_cov_cond``
        of either point set (largest/second covariance eigenvalue; coplanar
        is fine), with the sums they share computed once."""
        m = mask.to(torch.float32)
        w = m * fin_both
        wn = (w / (w.sum(-1, keepdim=True) + 1e-12))[..., None]
        mu_s = (src0 * wn).sum(-2)
        mu_t = (tgt0 * wn).sum(-2)
        H = ((src0 - mu_s[:, None]) * wn).transpose(-1, -2) @ (tgt0 - mu_t[:, None])
        Rm = _horn_rotation(H)
        t = mu_t - (Rm @ mu_s[..., None])[..., 0]
        maxres = torch.where(mask, residuals2(Rm, t), -torch.inf).max(-1).values
        # condition numbers: singular values of H, eigenvalues of each point
        # set's covariance; one analytic 3x3 solve for all three
        cov = _weighted_cov(both0, m * fin_each)
        ev = sym3_eigenvalues(torch.cat([(H.transpose(-1, -2) @ H)[None], cov]))
        s2 = torch.sqrt(torch.clamp(ev[0], min=0.0))
        c1 = torch.abs(s2[..., 2] / torch.where(s2[..., 1] > 1e-12, s2[..., 1], 1e-12))
        e1 = ev[1:, ..., 1]
        c_pts = torch.abs(ev[1:, ..., 2] / torch.where(torch.abs(e1) > 1e-12, e1, 1e-12))
        cond_ok = (c1 < CONDITION_THRESH) & (c_pts < CONDITION_THRESH).all(0)
        return Rm, t, maxres, cond_ok

    def select(m, a, b):
        return torch.where(m.reshape(-1, *([1] * (a.ndim - 1))), a, b)

    def any_of(*flags):
        """One device -> host read of several ``.any()`` flags."""
        nonlocal host_reads
        host_reads += 1
        return torch.stack([f.any() for f in flags]).tolist()

    host_reads = 0
    inlier = torch.zeros((P, R), dtype=torch.bool, device=dev)
    count = torch.zeros((P,), dtype=torch.int64, device=dev)
    Rm = torch.eye(3, dtype=torch.float32, device=dev).repeat(P, 1, 1)
    t = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    maxres = torch.full((P,), 100.0, dtype=torch.float32, device=dev)
    validT = torch.zeros((P,), dtype=torch.bool, device=dev)
    alive = torch.ones((P,), dtype=torch.bool, device=dev)

    for i in range(R if P else 0):
        # a pair leaves the scan at its first invalid entry or once full
        alive = alive & valid[:, i] & (count < max_filtered)
        # pixel-distance dedup vs current inliers (either image)
        cand_ok = alive & ~(inlier & near[:, i]).any(-1)
        tentative = inlier | (arange_r == i)
        n_new = count + 1
        # fewer than 3: accept without geometric checking
        fit = cand_ok & (n_new >= 3)
        any_alive, any_fit = any_of(alive, fit)
        if not any_alive:
            break
        if any_fit:
            R1, t1, m1, ok1 = geo(tentative)
            mask_s, n_s, R_s, t_s, m_s, ok_s = tentative, n_new, R1, t1, m1, ok1
            stop = torch.zeros_like(fit)
            while True:
                strip = fit & (m_s > max_res2) & (n_s > 3) & ~stop
                if not any_of(strip)[0]:
                    break
                # worst inlier under the current fit
                res = residuals2(R_s, t_s)
                worst = torch.where(mask_s, res, -torch.inf).argmax(-1)
                mask2 = mask_s & (arange_r != worst[:, None])
                n2 = n_s - 1
                R2, t2, m2, ok2 = geo(mask2)
                # stripped to 3 and still bad (or killed a previously valid
                # fit): restore the post-add state and stop
                revert = (n2 == 3) & ((m2 > max_res2) | (ok1 & ~ok2))
                keep = strip & ~revert
                back = strip & revert
                mask_s = select(keep, mask2, mask_s)
                n_s = select(keep, n2, n_s)
                R_s = select(keep, R2, select(back, R1, R_s))
                t_s = select(keep, t2, select(back, t1, t_s))
                m_s = select(keep, m2, m_s)
                ok_s = select(keep, ok2, select(back, ok1, ok_s))
                stop = stop | (strip & (revert | (m2 < max_res2)))
            Rm = select(fit, R_s, Rm)
            t = select(fit, t_s, t)
            maxres = select(fit, m_s, maxres)
            validT = select(fit, ok_s, validT)
            tentative = select(fit, mask_s, tentative)
            n_new = select(fit, n_s, n_new)
        inlier = select(cand_ok, tentative, inlier)
        count = select(cand_ok, n_new, count)

    valid_pair = (count >= min_num_matches) & (maxres < max_res2) & validT
    return {
        "inlier_mask": inlier & valid_pair[:, None],
        "count": torch.where(valid_pair, count, 0),
        "transform": _rt_to_mat(Rm, t),
        "valid_pair": valid_pair,
        "host_reads": host_reads,
    }


def kabsch_filter_pair(src_pts, tgt_pts, pix_src, pix_tgt, valid, max_filtered: int = 25,
                       min_num_matches: int = 4, max_res2: float = 4e-4):
    """:func:`kabsch_filter` for one image pair ([R, ...] inputs)."""
    out = kabsch_filter(src_pts[None], tgt_pts[None], pix_src[None], pix_tgt[None],
                        valid[None], max_filtered, min_num_matches, max_res2)
    return {k: v if k == "host_reads" else v[0] for k, v in out.items()}


# ---------------------------------------------------------------------------
# Stage 2: surface-area filter
# ---------------------------------------------------------------------------


def _obb_area_2d(p2, w):
    """Oriented-bounding-box area of weighted 2D points [..., N, 2]
    (reference ``computeAreaOrientedBoundingBox2``)."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    mu = (p2 * w[..., None]).sum(-2) / wsum
    c = p2 - mu[..., None, :]
    cov = (c * w[..., None]).transpose(-1, -2) @ c / wsum[..., None]
    _, evec = torch.linalg.eigh(cov)
    proj = p2 @ evec  # rotate into OBB space (translation irrelevant)
    big = 1e18
    on = w[..., None] > 0
    ext = torch.where(on, proj, -big).max(-2).values - torch.where(on, proj, big).min(-2).values
    ok = (ext > 1e-5).all(-1)
    return torch.where(ok, ext[..., 0] * ext[..., 1], 0.0)


def _surface_area_one(pts, w):
    """PCA-plane projected OBB area of each image's matched keypoints
    ([..., N, 3] points, [..., N] weights)."""
    w = torch.where(torch.isfinite(pts).all(-1), w, 0.0)
    pts = torch.where(w[..., None] > 0, pts, 0.0)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    mu = (pts * w[..., None]).sum(-2) / wsum
    _, evec = torch.linalg.eigh(_weighted_cov(pts, w))  # ascending: evec[..., 2] dominant
    ev0 = evec[..., 2]
    ev1 = evec[..., 1]
    ev2 = evec[..., 0]  # plane normal (smallest)
    rel = pts - mu[..., None, :]
    s = rel - (rel * ev2[..., None, :]).sum(-1, keepdim=True) * ev2[..., None, :]
    p2 = torch.stack([(s * ev0[..., None, :]).sum(-1), (s * ev1[..., None, :]).sum(-1)], -1)
    return _obb_area_2d(p2, w)


def surface_area_filter(src_pts, tgt_pts, inlier_mask, area_thresh: float = 0.032):
    """Reject a pair if the matched keys are near-degenerate (tiny spanned
    area) in BOTH images: the arguments and results of
    :func:`surface_area_filter_ref`.

    On CUDA tensors it launches ``kernels/surface_area.cu`` once (none for
    P = 0) on the current stream and reads nothing back; it raises if the
    kernel cannot be built or launched. On CPU tensors it runs
    :func:`surface_area_filter_ref`.
    """
    if not inlier_mask.is_cuda:
        return surface_area_filter_ref(src_pts, tgt_pts, inlier_mask, area_thresh)
    from bundlefusion_tpu_torch.kernels import surface_area_launch

    if inlier_mask.dim() == 1:   # one pair
        return tuple(x[0] for x in surface_area_filter(src_pts[None], tgt_pts[None],
                                                       inlier_mask[None], area_thresh))
    return surface_area_launch(*(x.contiguous() for x in (src_pts, tgt_pts, inlier_mask)),
                               area_thresh)


def surface_area_filter_ref(src_pts, tgt_pts, inlier_mask, area_thresh: float = 0.032):
    """Reject a pair if the matched keys are near-degenerate (tiny spanned
    area) in BOTH images, in torch ops: the plain version of
    ``kernels/surface_area.cu``. [P, R, ...] inputs (or one pair's
    [R, ...]); returns (keep_bool, area_src, area_tgt). On a CUDA tensor
    each of its ``torch.linalg.eigh`` calls makes the host wait for the
    card."""
    w = inlier_mask.to(torch.float32)
    a0 = _surface_area_one(src_pts, w)
    a1 = _surface_area_one(tgt_pts, w)
    keep = ~((a0 < area_thresh) & (a1 < area_thresh)) & (w.sum(-1) > 0)
    return keep, a0, a1


surface_area_filter_pair = surface_area_filter


# ---------------------------------------------------------------------------
# Stage 3: dense verify
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DenseVerifyParams:
    dist_thresh: float = 0.15      # s_projCorrDistThres
    normal_thresh: float = 0.97    # s_projCorrNormalThres
    err_thresh: float = 0.075      # s_verifySiftErrThresh
    corr_thresh: float = 0.02      # s_verifySiftCorrThresh
    depth_min: float = 0.1
    depth_max: float = 4.0


def _proj_error_one_way(T, in_depth, in_campos, in_normal, md_depth, md_campos, md_normal,
                        intr: CameraIntrinsics, p: DenseVerifyParams):
    """One direction of the symmetric projective check (reference
    ``computeProjError``, SIFTImageManager.cu:424-487): ``T`` [P, 4, 4]
    maps input -> model; images are [P, H, W(, 3)].

    Returns (sum_residual, sum_weight, num_corr), each [P].
    """
    pin, nin, din = in_campos, in_normal, in_depth
    ok_in = (
        torch.isfinite(pin).all(-1)
        & torch.isfinite(nin).all(-1)
        & torch.isfinite(din)
        & (din >= p.depth_min)
        & (din <= p.depth_max)
    )
    Rt = T[:, None, :3, :3].transpose(-1, -2)
    pt = pin @ Rt + T[:, None, None, :3, 3]
    nt = nin @ Rt
    z = pt[..., 2]
    zs = torch.clamp(z, min=1e-6)
    uf = torch.round(pt[..., 0] / zs * intr.fx + intr.cx)
    vf = torch.round(pt[..., 1] / zs * intr.fy + intr.cy)
    inb = (uf >= 0) & (uf < intr.width) & (vf >= 0) & (vf < intr.height) & (z > 0)
    uc = torch.where(inb, uf, 0.0).to(torch.int64)
    vc = torch.where(inb, vf, 0.0).to(torch.int64)

    ok_md = (
        torch.isfinite(md_campos).all(-1)
        & torch.isfinite(md_normal).all(-1)
        & torch.isfinite(md_depth)
    )
    stack_md = torch.cat(
        [
            torch.where(ok_md[..., None], md_campos, 0.0).movedim(-1, 1),
            torch.where(ok_md[..., None], md_normal, 0.0).movedim(-1, 1),
            torch.where(ok_md, md_depth, 0.0)[:, None],
            ok_md[:, None].to(torch.float32),
        ],
        dim=1,
    )  # [P, 8, H, W]
    smp = onehot_gather2d(stack_md, vc, uc, inb)
    ptgt = smp[..., 0:3]
    ntgt = smp[..., 3:6]
    dtgt = smp[..., 6]
    ok_tgt = (smp[..., 7] > 0.5) & (dtgt >= p.depth_min) & (dtgt <= p.depth_max)
    d = torch.linalg.norm(pt - ptgt, dim=-1)
    dn = (nt * ntgt).sum(-1)
    # free-space violation counts as a (bad) correspondence too
    known_bad = (z < dtgt) & (d > p.dist_thresh)
    good = (dn >= p.normal_thresh) & (d <= p.dist_thresh)
    counted = ok_in & inb & ok_tgt & (good | known_bad)
    z_norm = (z - p.depth_min) / (p.depth_max - p.depth_min)
    weight = torch.clamp(0.5 * ((1.0 - d / p.dist_thresh) + (1.0 - z_norm)), min=0.0)
    sum_res = torch.where(counted, d, 0.0).sum((-1, -2))
    sum_w = torch.where(counted, weight, 0.0).sum((-1, -2))
    n_corr = counted.to(torch.float32).sum((-1, -2))
    return sum_res, sum_w, n_corr


def dense_verify(T_ij, depth_i, campos_i, normal_i, depth_j, campos_j, normal_j,
                 intr: CameraIntrinsics, p: DenseVerifyParams = DenseVerifyParams()):
    """Symmetric dense verification of relative transforms ``T_ij`` [P, 4, 4]
    between cached frames i (input) and j (model). Either side's images are
    [P, H, W(, 3)], or one frame's [H, W(, 3)] shared by all pairs.

    Returns (keep_bool, err, corr_frac), each [P].
    """
    P = T_ij.shape[0]

    def per_pair(x, tail):
        return x if x.ndim == tail + 1 else x.expand(P, *x.shape)

    fi = (per_pair(depth_i, 2), per_pair(campos_i, 3), per_pair(normal_i, 3))
    fj = (per_pair(depth_j, 2), per_pair(campos_j, 3), per_pair(normal_j, 3))
    r1 = _proj_error_one_way(T_ij, *fi, *fj, intr, p)
    r2 = _proj_error_one_way(pose_inverse(T_ij), *fj, *fi, intr, p)
    sum_res = r1[0] + r2[0]
    sum_w = r1[1] + r2[1]
    n_corr = r1[2] + r2[2]
    err = sum_res / torch.clamp(sum_w, min=1e-12)
    corr = 0.5 * n_corr / float(intr.width * intr.height)
    keep = (corr >= p.corr_thresh) & (err <= p.err_thresh) & (sum_w > 0)
    return keep, err, corr


def dense_verify_pair(T_ij, depth_i, campos_i, normal_i, depth_j, campos_j, normal_j,
                      intr: CameraIntrinsics, p: DenseVerifyParams = DenseVerifyParams()):
    """:func:`dense_verify` for one pair: ``T_ij`` [4, 4], scalars back."""
    keep, err, corr = dense_verify(T_ij[None], depth_i, campos_i, normal_i,
                                   depth_j, campos_j, normal_j, intr, p)
    return keep[0], err[0], corr[0]
