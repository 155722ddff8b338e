"""Weighted Kabsch rigid alignment, batched over leading dimensions.

Port of ``bundlefusion_tpu/geometry/kabsch.py``. The reference functions
take one point set and are ``vmap``-ed over image pairs; here every
function takes ``[..., N, 3]`` points and ``[..., N]`` weights and carries
the leading dimensions through, so one call fits all pairs.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from bundlefusion_tpu_torch.geometry.lie import _rt_to_mat


def _horn_tables():
    """Horn's 4x4 N-matrix is linear in the 3x3 cross-covariance, and the
    rotation of a unit quaternion is linear in the quaternion's outer
    product: both as constant matrices, so each is one product on the card
    instead of dozens of scalar ops. Returns (N_of_H [16, 9], R_of_qq
    [9, 16], with R = I + R_of_qq @ vec(q q^T))."""
    xx, xy, xz, yx, yy, yz, zx, zy, zz = np.eye(9)
    n_of_h = np.stack([
        xx + yy + zz, yz - zy, zx - xz, xy - yx,
        yz - zy, xx - yy - zz, xy + yx, zx + xz,
        zx - xz, xy + yx, -xx + yy - zz, yz + zy,
        xy - yx, zx + xz, yz + zy, -xx - yy + zz,
    ])
    q = np.eye(16).reshape(4, 4, 16)     # q[a, b] picks q_a * q_b (order w, x, y, z)
    w, x, y, z = 0, 1, 2, 3
    r_of_qq = 2 * np.stack([
        -(q[y, y] + q[z, z]), q[x, y] - q[z, w], q[x, z] + q[y, w],
        q[x, y] + q[z, w], -(q[x, x] + q[z, z]), q[y, z] - q[x, w],
        q[x, z] - q[y, w], q[y, z] + q[x, w], -(q[x, x] + q[y, y]),
    ])
    return n_of_h.astype(np.float32), r_of_qq.astype(np.float32)


@lru_cache(maxsize=4)
def _horn_tables_on(device: torch.device):
    return tuple(torch.as_tensor(a, device=device) for a in _horn_tables())


def _weighted_centroids(src, dst, weights):
    """Shared front of both fits: mask non-finite points out, normalise the
    weights, centre. Returns (src, dst, w, mu_s, mu_d, H) with H the 3x3
    cross-covariance."""
    # zero-weight or non-finite points must not poison the sums (0 * nan = nan)
    finite = torch.isfinite(src).all(-1) & torch.isfinite(dst).all(-1)
    weights = torch.where(finite, weights, 0.0)
    src = torch.where(weights[..., None] > 0, src, 0.0)
    dst = torch.where(weights[..., None] > 0, dst, 0.0)
    w = weights / (weights.sum(-1, keepdim=True) + 1e-12)
    mu_s = (src * w[..., None]).sum(-2)
    mu_d = (dst * w[..., None]).sum(-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    H = (sc * w[..., None]).transpose(-1, -2) @ dc
    return src, dst, w, mu_s, mu_d, H


def _finish_fit(R, src, dst, w, mu_s, mu_d):
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    res = dst - (src @ R.transpose(-1, -2) + t[..., None, :])
    residual2 = ((res * res).sum(-1) * w).sum(-1)
    return _rt_to_mat(R, t), residual2


def kabsch(src, dst, weights=None):
    """Best rigid transform T with T @ src ~= dst (least squares), by SVD.

    Args:
      src, dst: [..., N, 3] points.
      weights: optional [..., N] nonnegative weights (zeros mask points out).

    Returns (T [..., 4, 4], residual2 [...]): the transform and the mean
    squared residual over the weighted points.
    """
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device)
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=torch.float32, device=src.device)
    src, dst, w, mu_s, mu_d, H = _weighted_centroids(src, dst, weights)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    return _finish_fit(V @ D @ Ut, src, dst, w, mu_s, mu_d)


def sym3_eigenvalues(A):
    """Analytic eigenvalues of symmetric 3x3 matrices [..., 3, 3], ascending
    (trigonometric closed form, branch-free). Used by the greedy Kabsch
    filter's condition-number checks."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (
        a01 * a01 + a02 * a02 + a12 * a12
    ) / 3.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    # det(B)/2 where B = (A - qI)
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e2 = q + 2.0 * p * torch.cos(phi)                        # largest
    e0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e1 = 3.0 * q - e0 - e2
    return torch.stack([e0, e1, e2], -1)


def _horn_rotation(H, num_iters: int = 16):
    """The rotation [..., 3, 3] that best aligns two centred point sets with
    cross-covariance ``H`` [..., 3, 3] (Horn's quaternion method): the top
    eigenvector of the 4x4 symmetric N-matrix, found by squaring the shifted
    matrix repeatedly. Always a proper rotation (no reflection case)."""
    n_of_h, r_of_qq = _horn_tables_on(H.device)
    N = (H.reshape(*H.shape[:-2], 9) @ n_of_h.T).reshape(*H.shape[:-2], 4, 4)

    def frob(M):
        return torch.linalg.matrix_norm(M, keepdim=True)

    # shift so all eigenvalues are positive and the top stays the top, then
    # square the matrix k times: M^(2^k) -> lambda_max^(2^k) v v^T
    M = N + (frob(N) + 1e-12) * torch.eye(4, dtype=N.dtype, device=N.device)
    M = M / frob(M)
    k_sq = max(3, int(math.ceil(math.log2(max(num_iters, 8)))) + 3)
    for _ in range(k_sq):
        M = M @ M
        M = M / torch.clamp(frob(M), min=1e-30)
    # every column of the limit is proportional to the top eigenvector
    col = torch.argmax((M * M).sum(-2), dim=-1)
    q = torch.gather(M, -1, col[..., None, None].expand(*M.shape[:-1], 1))[..., 0]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-20)
    qq = (q[..., :, None] * q[..., None, :]).reshape(*q.shape[:-1], 16)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    return eye + (qq @ r_of_qq.T).reshape(*q.shape[:-1], 3, 3)


def kabsch_fast(src, dst, weights, num_iters: int = 16):
    """Rigid alignment via Horn's quaternion method (see
    :func:`_horn_rotation`). No SVD, so it suits the greedy filter's many
    tiny fits.

    Returns (T [..., 4, 4], residual2 [...] weighted mean squared error).
    """
    src, dst, w, mu_s, mu_d, H = _weighted_centroids(src, dst, weights)
    return _finish_fit(_horn_rotation(H, num_iters), src, dst, w, mu_s, mu_d)


def kabsch_condition(src, weights=None, thresh: float = 100.0):
    """Degeneracy check of a source point set [..., N, 3]: the ratio of the
    largest to the smallest covariance eigenvalue must stay below
    ``thresh`` (reference KABSCH_CONDITION_THRESH).

    Returns (condition_ratio, ok_bool).
    """
    src = torch.as_tensor(src, dtype=torch.float32)
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=torch.float32, device=src.device)
    w = weights / (weights.sum(-1, keepdim=True) + 1e-12)
    mu = (src * w[..., None]).sum(-2)
    c = src - mu[..., None, :]
    cov = (c * w[..., None]).transpose(-1, -2) @ c
    ev = torch.linalg.eigvalsh(cov)
    ratio = ev[..., 2] / torch.clamp(ev[..., 0], min=1e-12)
    return ratio, ratio < thresh
