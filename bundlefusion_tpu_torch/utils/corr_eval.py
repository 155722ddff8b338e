"""Correspondence-filter evaluation against a ground-truth trajectory.

Port of ``bundlefusion_tpu/utils/corr_eval.py``, the analog of the
reference's compile-gated ``CorrespondenceEvaluator``
(``CorrespondenceEvaluator.{h,cpp}``): per filter stage, the precision and
recall of the matches against ground-truth poses, with CSV logs. A match
(i, j, p_i, p_j) counts as correct when || T_i p_i - T_j p_j || is below a
threshold under the ground-truth poses. The bookkeeping is numpy (the JAX
module's own, copied here); :func:`evaluate_frontend_fidelity` runs the
port's SIFT, matcher and filter cascade on a ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch


@dataclass
class StageStats:
    tp: int = 0
    fp: int = 0
    fn: int = 0

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else float("nan")

    @property
    def recall(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else float("nan")


class CorrespondenceEvaluator:
    def __init__(self, gt_poses: np.ndarray, dist_thresh: float = 0.05):
        """gt_poses: [N, 4, 4] camera-to-world ground truth."""
        self.gt = np.asarray(gt_poses, np.float64)
        self.thresh = dist_thresh
        self.stages: Dict[str, StageStats] = {}
        self.rows: List[dict] = []
        # per-pair raw dense-verify scores for offline threshold sweeps
        self.dense_rows: List[dict] = []

    def _is_correct(self, fi: int, fj: int, p_i: np.ndarray, p_j: np.ndarray) -> np.ndarray:
        Ti, Tj = self.gt[fi], self.gt[fj]
        wi = p_i @ Ti[:3, :3].T + Ti[:3, 3]
        wj = p_j @ Tj[:3, :3].T + Tj[:3, 3]
        return np.linalg.norm(wi - wj, axis=-1) < self.thresh

    def record_stage(self, stage: str, fi: int, fj: int, p_i: np.ndarray, p_j: np.ndarray,
                     candidate_mask: np.ndarray, kept_mask: np.ndarray):
        """Evaluate one filter stage for one image pair.

        candidate_mask: matches entering the stage; kept_mask: survivors.
        """
        correct = self._is_correct(fi, fj, p_i, p_j)
        st = self.stages.setdefault(stage, StageStats())
        kept = kept_mask & candidate_mask
        dropped = candidate_mask & ~kept_mask
        st.tp += int((kept & correct).sum())
        st.fp += int((kept & ~correct).sum())
        st.fn += int((dropped & correct).sum())
        self.rows.append({
            "stage": stage, "i": fi, "j": fj,
            "n_in": int(candidate_mask.sum()), "n_out": int(kept.sum()),
            "n_correct_in": int((candidate_mask & correct).sum()),
            "n_correct_out": int((kept & correct).sum()),
        })

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"precision": v.precision, "recall": v.recall, "tp": v.tp, "fp": v.fp,
                "fn": v.fn}
            for k, v in self.stages.items()
        }

    def to_csv(self, path: str):
        import csv

        with open(path, "w", newline="") as fh:
            if not self.rows:
                return
            w = csv.DictWriter(fh, fieldnames=list(self.rows[0].keys()))
            w.writeheader()
            w.writerows(self.rows)


# graded perturbations (m) of a pair's solved transform for the dense-verify
# threshold sweep
PERTURB_M = (0.01, 0.025, 0.05, 0.08, 0.15)


def _perturbed(T: np.ndarray, i: int, j: int, mag: float) -> np.ndarray:
    """The transform moved by ``mag`` along a pair-dependent axis and turned
    by ``mag / 2`` rad about it (small-angle)."""
    axis = np.array([np.sin(j * 1.7), np.cos(i * 2.3), np.sin(i + j)], np.float32)
    axis /= max(np.linalg.norm(axis), 1e-6)
    w = axis * (mag * 0.5)
    cw = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float32)
    Tp = T.copy()
    Tp[:3, :3] = (np.eye(3, dtype=np.float32) + cw) @ Tp[:3, :3]
    Tp[:3, 3] += axis * mag
    return Tp


def evaluate_frontend_fidelity(seq, intr, sift_cfg, frontend_params, intr_cache=None,
                               pair_stride=(1, 2, 4), dist_thresh: float = 0.05, device=None):
    """Run the full filter cascade on a ground-truth sequence and report
    per-stage precision / recall: the ``CorrespondenceEvaluator``
    methodology (CorrespondenceEvaluator.h:10-50, hooks in
    Bundler.cpp:145-203).

    Args:
      seq: dict with "depth" [N, H, W], "color" [N, H, W, 3], "poses"
        [N, 4, 4] (numpy).
      intr / intr_cache: the port's ``CameraIntrinsics`` of the input and,
        optionally, of the dense cache (which enables the dense-verify stage
        and its ``dense_rows``).
      pair_stride: frame-distance set to evaluate (adjacent + skips).
      device: where the cascade runs (the CUDA card unless the caller names
        another).

    Returns (evaluator, summary dict).
    """
    from bundlefusion_tpu_torch import default_device
    from bundlefusion_tpu_torch.ops.filters import (
        dense_verify_pair,
        kabsch_filter_pair,
        surface_area_filter_pair,
    )
    from bundlefusion_tpu_torch.ops.image import resample_nearest, rgb_to_intensity
    from bundlefusion_tpu_torch.ops.matching import match_descriptors_pair
    from bundlefusion_tpu_torch.ops.sift import detect_and_describe
    from bundlefusion_tpu_torch.pipeline.frames import (
        backproject_keys,
        create_dense_cache,
        store_cache_frame,
    )

    dev = torch.device(device) if device is not None else default_device()
    n = len(seq["depth"])
    ev = CorrespondenceEvaluator(seq["poses"], dist_thresh)
    fp = frontend_params

    def host(x):
        return x.cpu().numpy()

    kps, caches = [], []
    for i in range(n):
        d = torch.as_tensor(np.where(np.isfinite(seq["depth"][i]), seq["depth"][i], np.nan),
                            dtype=torch.float32, device=dev)
        c = torch.as_tensor(seq["color"][i], dtype=torch.float32, device=dev)
        kps.append(detect_and_describe(rgb_to_intensity(c), d, sift_cfg))
        if intr_cache is not None:
            cache = create_dense_cache(1, intr_cache.height, intr_cache.width, dev)
            h4, w4 = intr_cache.height * 4, intr_cache.width * 4
            caches.append(store_cache_frame(cache, 0, resample_nearest(d, h4, w4),
                                            torch.zeros((h4, w4, 3), device=dev), intr_cache))

    def dense(T, j, i):
        return dense_verify_pair(torch.as_tensor(T, device=dev),
                                 caches[j].depth[0], caches[j].campos[0], caches[j].normal[0],
                                 caches[i].depth[0], caches[i].campos[0], caches[i].normal[0],
                                 intr_cache, fp.dense)

    for di in pair_stride:
        for j in range(di, n):
            i = j - di
            a, b = kps[j], kps[i]
            m = match_descriptors_pair(a.desc, a.valid, b.desc, b.valid, fp.sift_match_thresh,
                                       fp.sift_match_ratio, fp.num_raw_matches)
            pix_a, pix_b = a.pos[m.idx_i], b.pos[m.idx_j]
            p_i_t = backproject_keys(pix_a, a.depth[m.idx_i], intr)
            p_j_t = backproject_keys(pix_b, b.depth[m.idx_j], intr)
            p_i, p_j = host(p_i_t), host(p_j_t)
            raw = host(m.valid)
            ev.record_stage("0_raw_match", j, i, p_i, p_j, raw, raw)

            kf = kabsch_filter_pair(p_i_t, p_j_t, pix_a, pix_b, m.valid, fp.max_filtered,
                                    fp.min_num_matches, fp.max_kabsch_res2)
            valid_pair = bool(kf["valid_pair"])
            inl = host(kf["inlier_mask"]) & valid_pair
            ev.record_stage("1_kabsch", j, i, p_i, p_j, raw, inl)

            sa_keep, _, _ = surface_area_filter_pair(p_i_t, p_j_t, kf["inlier_mask"],
                                                     fp.surf_area_thresh)
            inl2 = inl & bool(sa_keep)
            ev.record_stage("2_surface_area", j, i, p_i, p_j, inl, inl2)

            if intr_cache is None or not caches:
                continue
            T = host(kf["transform"])
            keep, dv_err, dv_corr = dense(T, j, i)
            inl3 = inl2 & bool(keep)
            ev.record_stage("3_dense_verify", j, i, p_i, p_j, inl2, inl3)
            # raw (err, corr) per pair for offline threshold sweeps: the
            # pair-level label is the majority of its stage-2 inliers
            correct = ev._is_correct(j, i, p_i, p_j)
            n_in = int(inl2.sum())
            ev.dense_rows.append({
                "j": j, "i": i, "err": float(dv_err), "corr": float(dv_corr), "n_in": n_in,
                "good": bool(n_in > 0 and (inl2 & correct).sum() >= 0.8 * n_in),
                "perturb_m": 0.0,
            })
            # graded perturbations: the thresholds exist to reject drifted
            # transforms (FilterMatchesByDenseVerifyCU,
            # SIFTImageManager.cu:491-606), so the sweep needs pairs whose
            # transform error straddles the decision surface; a row is good
            # iff the perturbation stays within the correctness threshold
            if valid_pair:
                for mag in PERTURB_M:
                    _, e_p, c_p = dense(_perturbed(T, i, j, mag), j, i)
                    ev.dense_rows.append({
                        "j": j, "i": i, "err": float(e_p), "corr": float(c_p), "n_in": n_in,
                        "good": bool(mag < dist_thresh), "perturb_m": float(mag),
                    })

    return ev, ev.summary()
