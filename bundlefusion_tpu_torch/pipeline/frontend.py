"""Per-frame sparse-frontend orchestration: match + filter + residuals.

Port of ``bundlefusion_tpu/pipeline/frontend.py``, the core of
``Bundler::matchAndFilter`` (Bundler.cpp:103-249): match the current image
against every previous image in its domain, run the filter cascade, emit
EntryJ residuals, and produce the chained per-frame pose estimate
(``computeSiftTransformCU``). Also keyframe fusion
(``SIFTImageManager::fuseToGlobal``).

``cur_slot`` is a host integer here, so the cascade runs over the live
slots only (those below ``cur_slot``) and the outputs are padded back to the
store's capacity: the JAX version computes every slot and masks, or, for
large stores, skips whole chunks above ``cur_slot``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.lie import pose_inverse
from bundlefusion_tpu_torch.ops.filters import (
    DenseVerifyParams,
    dense_verify,
    kabsch_filter,
    surface_area_filter,
)
from bundlefusion_tpu_torch.ops.matching import match_current_against_previous
from bundlefusion_tpu_torch.pipeline.frames import DenseCache, KeyframeStore, backproject_keys
from bundlefusion_tpu_torch.solver.residuals import CorrStore, append_corrs
from bundlefusion_tpu_torch.utils import segment_sum_sorted
from bundlefusion_tpu_torch.utils.timing import stage


@dataclass(frozen=True)
class FrontendParams:
    sift_match_thresh: float = 0.7
    sift_match_ratio: float = 0.8
    num_raw_matches: int = 128
    max_filtered: int = 25
    min_num_matches: int = 4
    max_kabsch_res2: float = 4e-4
    surf_area_thresh: float = 0.032
    use_dense_verify: bool = True
    dense: DenseVerifyParams = DenseVerifyParams()


def _index(ids, device):
    """Host indices as a slice when they are one ascending run (the usual
    case: slots 0..cur_slot-1, read as a view with no copy to the card),
    else as an index tensor."""
    if ids == list(range(ids[0], ids[0] + len(ids))):
        return slice(ids[0], ids[0] + len(ids))
    return torch.tensor(ids, device=device)


def match_and_filter(cur_slot: int, keys: KeyframeStore, cache: DenseCache,
                     intr_sift: CameraIntrinsics, intr_cache: CameraIntrinsics,
                     params: FrontendParams = FrontendParams(),
                     slots: Optional[Sequence[int]] = None, timing=None):
    """Match frame ``cur_slot`` against all previous slots in the store.

    Args:
      cur_slot: host integer.
      slots: optional host sequence of store slots to match against
        (default: every slot); entries at or above ``cur_slot`` or the
        capacity take no part.
      timing: optional ``TimingLog`` for the per-stage times.

    Returns a per-pair dict over P = len(slots) (= store capacity by
    default): ``pair_valid`` [P], ``transforms`` [P, 4, 4] (cur -> prev),
    ``num_inliers`` [P], ``inlier_mask`` [P, R], ``idx_cur``/``idx_prev``
    [P, R], ``p_cur``/``p_prev`` [P, R, 3] back-projected matched keypoints;
    pairs that took no part are all-zero with an identity transform. Also
    ``kabsch_host_reads``: the device -> host reads of the greedy filter,
    which only its plain version makes (on the CPU); the kernel makes none.
    """
    dev = keys.pos.device
    R = params.num_raw_matches
    cur_slot = int(cur_slot)
    all_slots = list(range(keys.capacity)) if slots is None else [int(s) for s in slots]
    P = len(all_slots)
    # positions in the output / store slots of the pairs that can be active
    live = [(n, s) for n, s in enumerate(all_slots) if s < cur_slot and s < keys.capacity]
    out = {
        "pair_valid": torch.zeros((P,), dtype=torch.bool, device=dev),
        "transforms": torch.eye(4, dtype=torch.float32, device=dev).repeat(P, 1, 1),
        "num_inliers": torch.zeros((P,), dtype=torch.int32, device=dev),
        "inlier_mask": torch.zeros((P, R), dtype=torch.bool, device=dev),
        "idx_cur": torch.zeros((P, R), dtype=torch.int32, device=dev),
        "idx_prev": torch.zeros((P, R), dtype=torch.int32, device=dev),
        "p_cur": torch.zeros((P, R, 3), dtype=torch.float32, device=dev),
        "p_prev": torch.zeros((P, R, 3), dtype=torch.float32, device=dev),
        "cur_slot": cur_slot,
        "num_keys_per_frame": keys.keys_per_frame,
        "kabsch_host_reads": 0,
    }
    if not live:
        return out
    sel = _index([s for _, s in live], dev)
    dst = _index([n for n, _ in live], dev)

    with stage(timing, "time_sift_matching"):
        cur_pos = keys.pos[cur_slot]
        cur_depth = keys.depth[cur_slot]
        prev_pos = keys.pos[sel]
        prev_depth = keys.depth[sel]
        m = match_current_against_previous(
            keys.desc[cur_slot], keys.valid[cur_slot], keys.desc[sel], keys.valid[sel],
            keys.frame_valid[sel], params.sift_match_thresh, params.sift_match_ratio, R,
        )
        # back-project matched keys
        pix_cur = cur_pos[m.idx_i]                               # [L, R, 2]
        pix_prev = prev_pos.gather(1, m.idx_j[..., None].expand(-1, -1, 2))
        p_cur = backproject_keys(pix_cur, cur_depth[m.idx_i], intr_sift)
        p_prev = backproject_keys(pix_prev, prev_depth.gather(1, m.idx_j), intr_sift)

    with stage(timing, "time_match_filter_key_point"):
        kf = kabsch_filter(p_cur, p_prev, pix_cur, pix_prev, m.valid, params.max_filtered,
                           params.min_num_matches, params.max_kabsch_res2)

    with stage(timing, "time_match_filter_surface_area"):
        sa_keep, _, _ = surface_area_filter(p_cur, p_prev, kf["inlier_mask"],
                                            params.surf_area_thresh)
        pair_valid = kf["valid_pair"] & sa_keep

    if params.use_dense_verify:
        with stage(timing, "time_match_filter_dense_verify"):
            # T maps cur -> prev; verify with input=cur, model=prev
            dv_keep, _, _ = dense_verify(
                kf["transform"],
                cache.depth[cur_slot], cache.campos[cur_slot], cache.normal[cur_slot],
                cache.depth[sel], cache.campos[sel], cache.normal[sel],
                intr_cache, params.dense,
            )
            pair_valid = pair_valid & dv_keep

    inlier = kf["inlier_mask"] & pair_valid[:, None]
    out["kabsch_host_reads"] = kf["host_reads"]
    out["pair_valid"][dst] = pair_valid
    out["transforms"][dst] = kf["transform"]
    out["num_inliers"][dst] = inlier.sum(-1).to(torch.int32)
    out["inlier_mask"][dst] = inlier
    out["idx_cur"][dst] = m.idx_i.to(torch.int32)
    out["idx_prev"][dst] = m.idx_j.to(torch.int32)
    out["p_cur"][dst] = p_cur
    out["p_prev"][dst] = p_prev
    return out


def add_to_residuals(store: CorrStore, mf, cur_frame_global: int, prev_frame_global) -> CorrStore:
    """Append surviving matches as EntryJ residuals, in place
    (``AddCurrToResidualsCU``, SIFTImageManager.cu:610-687).

    Args:
      mf: output of :func:`match_and_filter`.
      cur_frame_global: global image index of the current frame.
      prev_frame_global: [P] int global image indices of the slots.

    Also records flat key ids (slot * K + key index) per endpoint, the
    reference's ``d_globMatchesKeyPointIndices``, consumed by track fusion.
    """
    P, R = mf["inlier_mask"].shape
    K = mf["num_keys_per_frame"]
    dev = mf["inlier_mask"].device
    prev = torch.as_tensor(prev_frame_global, device=dev).to(torch.int32)
    img_i = torch.full((P * R,), int(cur_frame_global), dtype=torch.int32, device=dev)
    img_j = prev[:, None].expand(P, R).reshape(-1)
    key_i = (mf["cur_slot"] * K + mf["idx_cur"]).reshape(-1)
    key_j = (torch.arange(P, dtype=torch.int32, device=dev)[:, None] * K
             + mf["idx_prev"]).reshape(-1)
    return append_corrs(
        store, img_i, img_j, mf["p_cur"].reshape(-1, 3), mf["p_prev"].reshape(-1, 3),
        mf["inlier_mask"].reshape(-1), key_i, key_j,
    )


def chained_sift_transform(mf, prev_world_transforms):
    """Pose of the current frame by chaining the best (nearest previous)
    filtered match (``computeSiftTransformCU``): T_world_cur =
    T_world_prev @ T_prev<-cur. mf["transforms"][p] maps cur -> prev.

    Args:
      prev_world_transforms: [P, 4, 4] world poses of the previous slots.

    Returns (T_world_cur [4, 4], found bool [], best_prev_slot int []),
    all on the device.
    """
    pv = mf["pair_valid"]
    P = pv.shape[0]
    score = torch.where(pv, torch.arange(P, device=pv.device), -1)
    best = torch.argmax(score)
    found = score.max() >= 0
    # by index_select: indexing with a 0-d tensor reads it back to the host
    pick = best.reshape(1)
    T = (prev_world_transforms.index_select(0, pick)[0]
         @ mf["transforms"].index_select(0, pick)[0])
    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    return torch.where(found, T, eye), found, best


# maximum world-space corr error for a match to contribute to a track's
# averaged position (MAX_TRACK_CORR_ERROR, SIFTImageManager.cpp:380)
MAX_TRACK_CORR_ERROR = 0.03


def fuse_keyframe(keys: KeyframeStore, corrs: CorrStore, local_world, frame0_slot: int,
                  intr_sift: CameraIntrinsics, max_out_keys: int = 1024):
    """Fuse a solved submap's keypoints into one keyframe in frame-0 coords
    by feature *tracks*, mirroring ``SIFTImageManager::fuseToGlobal`` +
    ``computeTracks`` (SIFTImageManager.cpp:380-476):

    - tracks = connected components of keypoints linked by the submap's
      filtered correspondences (min-label propagation over the corr edges);
    - a track's position is the average of its members' solved-trajectory
      world positions, counting only corrs with error < 0.03 m (high-error
      corrs still join the component but contribute no position);
    - the representative descriptor/scale come from the track's seed key
      (lowest key id, the reference's ``track.front()``);
    - the averaged position projects into frame 0; up to ``max_out_keys``
      keys survive, nearest-depth first, equal depths by lower key id.

    ``local_world`` [S, 4, 4] is the solved submap trajectory. Returns a
    dict of fused key arrays (pos/depth/response/scale/valid/desc).
    """
    S, K = keys.valid.shape
    NK = S * K
    dev = keys.pos.device
    rel = pose_inverse(local_world[frame0_slot]) @ local_world       # [S, 4, 4]

    key_ok = (keys.valid & keys.frame_valid[:, None]).reshape(NK)

    # ---- edges ----
    ki = torch.clamp(corrs.key_i, 0, NK - 1).to(torch.int64)
    kj = torch.clamp(corrs.key_j, 0, NK - 1).to(torch.int64)
    v = corrs.valid_mask() & key_ok[ki] & key_ok[kj]
    Ti = rel[torch.clamp(corrs.img_i, 0, S - 1).to(torch.int64)]
    Tj = rel[torch.clamp(corrs.img_j, 0, S - 1).to(torch.int64)]
    wi = (Ti[:, :3, :3] @ corrs.p_i[..., None])[..., 0] + Ti[:, :3, 3]
    wj = (Tj[:, :3, :3] @ corrs.p_j[..., None])[..., 0] + Tj[:, :3, 3]
    err = torch.linalg.norm(wi - wj, dim=-1)
    low = v & (err < MAX_TRACK_CORR_ERROR)

    # ---- connected components by min-label propagation; edges that take
    # no part write to a spare last element ----
    own = torch.arange(NK, device=dev)
    labels = torch.cat([torch.where(key_ok, own, NK), own.new_full((1,), NK)])
    dst_i = torch.where(v, ki, NK)
    dst_j = torch.where(v, kj, NK)
    for _ in range(S + 2):
        m = torch.minimum(labels[ki], labels[kj])
        labels = labels.scatter_reduce(0, dst_i, m, "amin")
        labels = labels.scatter_reduce(0, dst_j, m, "amin")
    labels = labels[:NK]

    # ---- per-track position average over low-error members ----
    # (an ordered sum over the corrs sorted by label, in store order within
    # a label: a scatter-add would round differently from run to run on the
    # card)
    lab_e = torch.where(low, labels[ki], NK)                         # == labels[kj]
    by_label = torch.argsort(lab_e, stable=True)
    contrib = torch.cat([wi + wj, torch.where(low, 2.0, 0.0)[:, None]], -1)
    sums = segment_sum_sorted(contrib[by_label], lab_e[by_label], NK + 1)
    sum_pos, cnt = sums[:, :3], sums[:, 3]
    avg = sum_pos[:NK] / torch.clamp(cnt[:NK, None], min=1.0)

    # ---- roots -> fused keys ----
    root = key_ok & (labels == own) & (cnt[:NK] > 0)
    z = avg[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = avg[:, 0] / zs * intr_sift.fx + intr_sift.cx
    vv = avg[:, 1] / zs * intr_sift.fy + intr_sift.cy
    out_ok = (
        root & (z > 0.05)
        & (u >= 0) & (u <= intr_sift.width - 1)
        & (vv >= 0) & (vv <= intr_sift.height - 1)
    )

    # nearest-depth-first cap (reference depth sort at the 1024 cap)
    score = torch.where(out_ok, -z, -torch.inf)
    k_eff = min(max_out_keys, NK)
    top_score, sel = torch.sort(score, descending=True, stable=True)
    top_score, sel = top_score[:k_eff], sel[:k_eff]
    if k_eff < max_out_keys:
        pad = max_out_keys - k_eff
        top_score = torch.cat([top_score, top_score.new_full((pad,), -torch.inf)])
        sel = torch.cat([sel, sel.new_zeros(pad)])
    valid_out = torch.isfinite(top_score)
    return {
        "pos": torch.stack([u[sel], vv[sel]], -1),
        "depth": z[sel],
        "response": torch.where(valid_out, keys.response.reshape(NK)[sel], 0.0),
        "scale": keys.scale.reshape(NK)[sel],
        "valid": valid_out,
        "desc": keys.desc.reshape(NK, 128)[sel],
    }
