"""Trajectory evaluation: ATE RMSE.

Port of ``bundlefusion_tpu/utils/metrics.py`` (``PoseHelper::evaluateAteRmse``):
Kabsch-align the estimated trajectory translations to ground truth over the
frames where both are valid, then report the RMSE of the aligned translation
errors. Invalid poses (any non-finite entry) are skipped. Host-side numpy in
float64, like the reference.
"""

from __future__ import annotations

import numpy as np


def evaluate_ate_rmse(est_poses, gt_poses):
    """ATE RMSE between two trajectories of 4x4 camera-to-world matrices.

    Args:
      est_poses: [N, 4, 4] estimated; invalid frames = non-finite entries.
      gt_poses:  [N, 4, 4] ground truth; same convention.

    Returns:
      (rmse_meters, num_valid_frames)
    """
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    if est.shape != gt.shape or est.ndim != 3:
        raise ValueError(f"trajectories must both be [N, 4, 4]: {est.shape} vs {gt.shape}")
    valid = np.isfinite(est).all(axis=(1, 2)) & np.isfinite(gt).all(axis=(1, 2))
    n = int(valid.sum())
    if n < 3:
        return float("inf"), n
    p_est = est[valid][:, :3, 3]
    p_gt = gt[valid][:, :3, 3]
    mu_e = p_est.mean(axis=0)
    mu_g = p_gt.mean(axis=0)
    H = (p_est - mu_e).T @ (p_gt - mu_g)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = mu_g - R @ mu_e
    aligned = p_est @ R.T + t
    err = aligned - p_gt
    rmse = float(np.sqrt((err * err).sum(axis=1).mean()))
    return rmse, n
