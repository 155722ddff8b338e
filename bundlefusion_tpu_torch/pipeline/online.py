"""Online BundleFusion engine: the per-frame path.

Port of the per-frame half of ``bundlefusion_tpu/pipeline/online.py``:

- ``_frame_step``: wire decode and frame archive, SIFT detect / describe,
  keypoint and dense-cache stores, matching against the submap's frames, the
  Kabsch -> surface-area -> dense-verify cascade, the correspondence store
  and the chained pose (the reference's ``Bundler::matchAndFilter`` +
  ``computeCurrentSiftTransform``);
- the fused TSDF dispatch with its re-integration budget
  (``DepthSensing.cpp: reintegrate()`` then ``integrate()``), garbage
  collection, the per-frame splat render, the re-integration drain of
  ``finish()`` and mesh extraction;
- ``_rollover_local``: the submap window's rollover.

Not ported yet: the solver, ``submap_step`` (local and global bundle
adjustment, keyframe fusion into the global graph), retirement and
revalidation. So this class has no ``process_frame`` / ``finish`` yet; it
is driven through the same private methods, in the same order, as the JAX
engine's ``process_frame`` calls them, and its poses are the chained SIFT
estimates, not optimized ones.

The JAX engine fuses each phase into one jitted program and lags results
by a frame to hide TPU dispatch latency; here every step runs eagerly on
the engine's device and all state is updated in place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from bundlefusion_tpu_torch import default_device
from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.ops.image import (
    erode_depth,
    resample_bilinear,
    resample_nearest,
    rgb_to_intensity,
)
from bundlefusion_tpu_torch.ops.filters import DenseVerifyParams
from bundlefusion_tpu_torch.ops.sift import SiftConfig, detect_and_describe
from bundlefusion_tpu_torch.pipeline.frames import (
    DenseCache,
    FrameStore,
    KeyframeStore,
    copy_cache_frame,
    create_dense_cache,
    create_frame_store,
    create_keyframe_store,
    decode_frame,
    dense_cache_from_numpy,
    encode_frame,
    keyframe_store_from_numpy,
    load_frames,
    put_frame,
    store_cache_frame,
    store_keypoints,
)
from bundlefusion_tpu_torch.pipeline.frontend import (
    FrontendParams,
    add_to_residuals,
    chained_sift_transform,
    match_and_filter,
)
from bundlefusion_tpu_torch.solver.residuals import (
    CorrStore,
    corr_store_from_numpy,
    create_corr_store,
)
from bundlefusion_tpu_torch.pipeline.trajectory import TrajectoryManager
from bundlefusion_tpu_torch.tsdf.apply_ops import apply_tsdf_ops
from bundlefusion_tpu_torch.tsdf.integrate import TsdfParams, candidate_keys
from bundlefusion_tpu_torch.tsdf.splat import SplatParams, splat_render
from bundlefusion_tpu_torch.tsdf.table import (
    ALLOC_COMPACT,
    EMPTY_KEY,
    allocate_packed,
    create_table,
    garbage_collect,
)
from bundlefusion_tpu_torch.utils import owned_tensor
from bundlefusion_tpu_torch.utils.timing import TimingLog

REINT_ROWS = 5  # max re-integration rows per frame (2 ops each, budget 10)


@dataclass
class LocalState:
    """Device-resident per-submap state (the reference's ``m_local`` Bundler:
    SIFTImageManager arrays + CUDACache + EntryJ store + relative poses)."""

    keys: KeyframeStore     # [S] keypoint store
    cache: DenseCache       # [S] dense cache
    corrs: CorrStore        # intra-submap EntryJ store
    rel: torch.Tensor       # [S, 4, 4] frame -> submap-anchor transforms
    valid: torch.Tensor     # [S] bool per-frame tracking validity


def local_state_from_numpy(arrays: dict, device) -> LocalState:
    """A ``LocalState`` from nested dicts of numpy arrays with the field
    names: ``keys`` / ``cache`` / ``corrs`` as their own constructors take
    them, ``rel`` [S, 4, 4] and ``valid`` [S]."""
    return LocalState(
        keys=keyframe_store_from_numpy(arrays["keys"], device),
        cache=dense_cache_from_numpy(arrays["cache"], device),
        corrs=corr_store_from_numpy(arrays["corrs"], device),
        rel=owned_tensor(arrays["rel"], torch.float32, device),
        valid=owned_tensor(arrays["valid"], torch.bool, device),
    )


def preprocess_frame(depth, color, sift_hw, int_hw):
    """Input-res depth/color -> (intensity_sift, depth_sift, depth_int,
    color_int): erode depth twice, resample (``CUDAImageManager::process``
    + ``resampleToIntensity``)."""
    d = erode_depth(erode_depth(depth))
    sh, sw = sift_hw
    ih, iw = int_hw
    intensity = rgb_to_intensity(color)
    intensity_sift = resample_bilinear(intensity, sh, sw)
    depth_sift = resample_nearest(d, sh, sw)
    depth_int = resample_nearest(d, ih, iw)
    color_int = resample_bilinear(color, ih, iw)
    return intensity_sift, depth_sift, depth_int, color_int


class BundleFusion:
    """The engine's per-frame path: ``_frame_step`` (pose from SIFT matches
    within the submap window), TSDF dispatch, render, mesh. There is no
    ``process_frame`` / ``finish`` yet: they need ``submap_step`` and the
    solver, which are not ported."""

    def __init__(
        self,
        intr_input: CameraIntrinsics,
        app: AppConfig = AppConfig(),
        bundling: BundlingConfig = BundlingConfig(),
        sift_cfg=None,
        max_keyframes: Optional[int] = None,
        mesh=None,
        device=None,
    ):
        """Same signature as the JAX engine plus the ``device`` the state
        lives on: the CUDA card unless the caller names another (with no
        card and no ``device`` this raises). A multi-device ``mesh`` is not
        supported yet."""
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported yet")
        if app.streaming_enabled:
            raise NotImplementedError("host paging (streaming) is not ported yet")
        self.device = torch.device(device) if device is not None else default_device()
        self.app = app
        self.bundling = bundling
        self.intr_input = intr_input
        self.intr_sift = intr_input.scaled(bundling.width_sift, bundling.height_sift)
        self.intr_int = intr_input.scaled(app.integration_width, app.integration_height)
        self.intr_cache = intr_input.scaled(
            bundling.downsampled_width, bundling.downsampled_height
        )
        self.sift_cfg = sift_cfg or SiftConfig(
            target_keys=bundling.feature_count_threshold,
            min_scale=bundling.min_key_scale,
            depth_min=app.sensor_depth_min,
            depth_max=app.sensor_depth_max,
        )
        self.S = bundling.submap_size + 1  # +1: one-frame overlap
        self.G = max_keyframes or bundling.max_num_images

        self.tsdf_params = TsdfParams(
            voxel_size=app.sdf_voxel_size,
            truncation=app.sdf_truncation,
            truncation_scale=app.sdf_truncation_scale,
            max_integration_distance=app.sdf_max_integration_distance,
            integration_weight_sample=app.sdf_integration_weight_sample,
            integration_weight_max=app.sdf_integration_weight_max,
            depth_min=app.sensor_depth_min,
            depth_max=app.sensor_depth_max,
        )
        self.table = create_table(app.hash_key_capacity, app.hash_num_sdf_blocks, self.device)
        self.vis_cap = app.visible_blocks_cap

        dense = DenseVerifyParams(
            dist_thresh=bundling.proj_corr_dist_thres,
            normal_thresh=bundling.proj_corr_normal_thres,
            err_thresh=bundling.verify_sift_err_thresh,
            corr_thresh=bundling.verify_sift_corr_thresh,
            depth_min=app.sensor_depth_min,
            depth_max=app.sensor_depth_max,
        )
        self.frontend_local = FrontendParams(
            sift_match_thresh=bundling.sift_match_thresh,
            sift_match_ratio=bundling.sift_match_ratio_max_local,
            num_raw_matches=bundling.max_matches_per_image_pair_raw,
            max_filtered=bundling.max_matches_per_image_pair_filtered,
            min_num_matches=bundling.min_num_matches_local,
            max_kabsch_res2=bundling.max_kabsch_residual2,
            surf_area_thresh=bundling.surf_area_pca_thresh,
            dense=dense,
        )
        self.frontend_global = dataclasses.replace(
            self.frontend_local,
            sift_match_ratio=bundling.sift_match_ratio_max_global,
            min_num_matches=bundling.min_num_matches_global,
        )

        # ---- device-resident state ----
        self.local = self._fresh_local()
        # the current submap's anchor pose; stays on the device
        self.submap_base = torch.eye(4, dtype=torch.float32, device=self.device)
        self.timing = TimingLog()

        # device-resident frame archive for re-integration
        sub_len = self.S - 1
        self.frame_cap = min(app.max_frames, self.G * sub_len + self.S)
        self.store: FrameStore = create_frame_store(
            self.frame_cap, self.intr_int.height, self.intr_int.width, self.device
        )

        self.frame_idx = 0
        self.frame_valid: List[bool] = []
        self.sift_world: List[np.ndarray] = []     # per-frame chained estimate
        self.complete_traj: List[np.ndarray] = []  # per-frame optimized 4x4 (nan invalid)
        self.traj_manager = TrajectoryManager(app.top_n_active, app.min_pose_dist_sqrt)
        # re-integration accounting: frames that dispatched the rows path +
        # total de/re-integration ops
        self.reint_frames = 0
        self.reint_ops_total = 0
        self.render_every = 1 if app.reconstruction_enabled else 0
        self.last_render = None

        self._splat = SplatParams(
            depth_min=app.render_depth_min,
            depth_max=app.render_depth_max,
            visible_cap=min(self.vis_cap, 8192),
        )

    # ------------------------------------------------------------------
    def _fresh_local(self) -> LocalState:
        S, dev = self.S, self.device
        return LocalState(
            keys=create_keyframe_store(S, self.sift_cfg.target_keys, dev),
            cache=create_dense_cache(S, self.intr_cache.height, self.intr_cache.width, dev),
            corrs=create_corr_store(self.bundling.max_local_corr, dev),
            rel=torch.eye(4, dtype=torch.float32, device=dev).repeat(S, 1, 1),
            valid=torch.zeros((S,), dtype=torch.bool, device=dev),
        )

    def _rollover_local(self) -> None:
        """The window rollover at a submap boundary: the overlap frame (slot
        S-1: keys, cache, validity) becomes slot 0 of a fresh window with
        identity relative poses and an empty correspondence store."""
        old, new = self.local, self._fresh_local()
        last = self.S - 1
        copy_cache_frame(new.cache, 0, old.cache, last)
        for f in dataclasses.fields(KeyframeStore):
            getattr(new.keys, f.name)[0] = getattr(old.keys, f.name)[last]
        new.valid[0] = old.valid[last]
        self.local = new

    def _frame_step(self, depth_u16, color_u8, cur_slot: int, store_slot: int):
        """One frame: archive -> detect -> store -> match/filter -> chain,
        on ``self.local``, ``self.store`` and ``self.submap_base``.

        ``cur_slot`` is the frame's position in the submap window,
        ``store_slot`` its slot in the frame archive. Returns (T_world
        [4, 4], valid bool []) as tensors on the device; nothing is read
        back here. TSDF work happens in the separate ``_tsdf_dispatch``.
        """
        loc, log = self.local, self.timing
        with log.stage("time_sensor_process"):
            intensity_sift, depth_sift, depth_int, color_int = self._archive_frame(
                depth_u16, color_u8, store_slot)
        kp = detect_and_describe(intensity_sift, depth_sift, self.sift_cfg, timing=log)
        with log.stage("time_store"):
            store_keypoints(loc.keys, cur_slot, kp)
            store_cache_frame(loc.cache, cur_slot, depth_int, color_int, self.intr_cache)

        if cur_slot > 0:
            mf = match_and_filter(cur_slot, loc.keys, loc.cache, self.intr_sift,
                                  self.intr_cache, self.frontend_local, timing=log)
            with log.stage("time_misc"):
                add_to_residuals(loc.corrs, mf, cur_slot,
                                 torch.arange(self.S, dtype=torch.int32, device=self.device))
                T_chain, found, _ = chained_sift_transform(mf, loc.rel)
                # nothing found: hold the previous frame's pose
                T_rel = torch.where(found, T_chain, loc.rel[cur_slot - 1])
                valid = found
        else:
            T_rel = torch.eye(4, dtype=torch.float32, device=self.device)
            valid = torch.ones((), dtype=torch.bool, device=self.device)
        loc.rel[cur_slot] = T_rel
        loc.valid[cur_slot] = valid
        return self.submap_base @ T_rel, valid

    def _read_pose(self, T_world: torch.Tensor, valid: torch.Tensor):
        """The frame's one device -> host copy: 17 floats, the pose and the
        validity flag together. The TSDF dispatch needs ``valid`` on the
        host (its op signs are host lists) and the trajectory bookkeeping
        needs the pose. Returns (T_world [4, 4] numpy, valid bool)."""
        packed = torch.cat([T_world.reshape(16), valid.to(torch.float32).reshape(1)]).cpu()
        return packed[:16].reshape(4, 4).numpy(), bool(packed[16] > 0.5)

    # ------------------------------------------------------------------
    def _apply_tsdf_ops(self, depths, colors, poses, signs, img_of_op):
        """Fused multi-op TSDF update of ``self.table`` (in place).
        Ops apply sequentially; sign 0 is an exact no-op."""
        apply_tsdf_ops(self.table, depths, colors, poses, signs, img_of_op,
                       self.intr_int, self.tsdf_params)

    def _render(self, table, cam_to_world):
        return splat_render(table, self.intr_int, self._as_pose(cam_to_world),
                            self.tsdf_params, self._splat)

    def _render_frame(self, f: int, T_world):
        """The per-frame visualisation of ``process_frame``: splat the TSDF
        at the frame's pose into ``last_render`` every ``render_every``
        frames (the reference renders every frame)."""
        if self.render_every and f % self.render_every == 0:
            self.last_render = self._render(self.table, T_world)

    def _as_pose(self, T) -> torch.Tensor:
        return torch.as_tensor(T, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    @staticmethod
    def _to_wire(depth, color):
        """Host-side compaction to the upload wire format (uint16 mm depth /
        uint8 color), mirroring the .sens on-disk representation."""
        depth = np.asarray(depth)
        color = np.asarray(color)
        if depth.dtype != np.uint16:
            d = np.where(np.isfinite(depth), depth, 0.0)
            depth = np.clip(d * 1000.0 + 0.5, 0, 65535).astype(np.uint16)
        if color.dtype != np.uint8:
            color = np.clip(color * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return depth, color

    def _store_slot(self, f: int) -> int:
        """Frame archive slot: frames beyond capacity land in the scratch
        slot (they become non-re-integrable)."""
        return f if f < self.frame_cap else self.frame_cap

    def _archive_frame(self, depth_u16, color_u8, store_slot: int):
        """The archive step of ``frame_step``: decode the wire frame, erode
        and resample it, archive it at integration resolution, and return
        (intensity_sift, depth_sift, depth_int, color_int) with the
        integration-res images DECODED from the archive, so a later
        de-integration subtracts bitwise-identical contributions."""
        dev = self.device
        d_u16 = torch.as_tensor(np.asarray(depth_u16).astype(np.int32), device=dev)
        c_u8 = torch.as_tensor(np.asarray(color_u8), device=dev)
        depth = torch.where(d_u16 > 0, d_u16.to(torch.float32) * 1e-3, torch.nan)
        color = c_u8.to(torch.float32) * (1.0 / 255.0)
        intensity_sift, depth_sift, depth_int, color_int = preprocess_frame(
            depth, color,
            (self.intr_sift.height, self.intr_sift.width),
            (self.intr_int.height, self.intr_int.width),
        )
        d_mm, c_q = encode_frame(depth_int, color_int)
        put_frame(self.store, store_slot, d_mm, c_q)
        depth_int, color_int = decode_frame(d_mm, c_q)
        return intensity_sift, depth_sift, depth_int, color_int

    def _record_frame(self, f: int, T_world: np.ndarray, valid: bool):
        """Host bookkeeping for one frame."""
        assert f == len(self.frame_valid)
        T_world = np.asarray(T_world, np.float32)
        self.frame_valid.append(valid)
        self.sift_world.append(T_world.copy())
        self.complete_traj.append(
            T_world.copy() if valid else np.full((4, 4), np.nan, np.float32)
        )
        if valid and self.app.integration_enabled:
            self.traj_manager.add_frame(f, T_world)
        else:
            self.traj_manager.add_frame(f, None)

    def _push_optimized_to_manager(self):
        """Feed the current complete trajectory to the re-integration
        scheduler (``TrajectoryManager::updateOptimizedTransform``)."""
        n = len(self.complete_traj)
        poses = np.stack(self.complete_traj) if n else np.zeros((0, 4, 4))
        valid = np.isfinite(poses).all(axis=(1, 2)) if n else np.zeros((0,), bool)
        self.traj_manager.update_optimized_transforms(poses, valid)

    # ------------------------------------------------------------------
    def _decode_frames(self, fids):
        return decode_frame(*load_frames(self.store, fids))

    def _tsdf_fast(self, fid: int, T_cur, valid: bool):
        """Typical frame: the current frame's fuse only — one allocation
        and one kernel sweep."""
        dev = self.device
        T_cur = self._as_pose(T_cur)
        d, c = self._decode_frames(torch.tensor([fid], device=dev))
        packed = candidate_keys(d[0], self.intr_int, T_cur, self.tsdf_params)
        if not valid:
            packed = torch.full_like(packed, EMPTY_KEY)
        allocate_packed(self.table, packed)
        # signs and image indices stay on the host: the op reads nothing back
        self._apply_tsdf_ops(d, c, T_cur[None], [1.0 if valid else 0.0], [0])

    def _tsdf_rows(self, packed_rows: np.ndarray, fid_cur: int, T_cur, cur_valid: bool):
        """Re-integration frame: up to R rows (de/re/int ops) plus the
        current frame's fuse, in one batched allocation and one kernel
        sweep. ``packed_rows`` [R, 34] = fid | op | T_old flat | T_new flat
        (op: 0 skip, 1 de-integrate, 2 de+re, 3 integrate)."""
        R = REINT_ROWS
        dev = self.device
        T_cur = self._as_pose(T_cur)
        rows = torch.as_tensor(packed_rows, dtype=torch.float32, device=dev)
        row_fids = rows[:, 0].to(torch.int64)
        T_olds = rows[:, 2:18].reshape(R, 4, 4)
        T_news = rows[:, 18:34].reshape(R, 4, 4)
        fids = torch.cat([row_fids, torch.tensor([fid_cur], device=dev)])
        depths, colors = self._decode_frames(fids)           # [R+1, ...]
        host_ops = [int(m) for m in np.asarray(packed_rows)[:, 1]]
        de_en = [m in (1, 2) for m in host_ops]
        re_en = [m in (2, 3) for m in host_ops]

        # ops: [de_0, re_0, de_1, re_1, ..., current]; signs and image
        # indices stay on the host, so the op reads nothing back
        poses = torch.cat([torch.stack([T_olds, T_news], 1).reshape(2 * R, 4, 4), T_cur[None]])
        signs = [s for de, re in zip(de_en, re_en) for s in (-float(de), float(re))]
        signs.append(float(bool(cur_valid)))
        img_of_op = [i for i in range(R) for _ in (0, 1)] + [R]

        # batched allocation: re-integration targets + current frame, with
        # the dedup budget scaled so each frame keeps its own
        alloc_en = torch.tensor(re_en + [bool(cur_valid)], device=dev)
        alloc_T = torch.cat([T_news, T_cur[None]])
        packed = torch.stack([
            candidate_keys(depths[i], self.intr_int, alloc_T[i], self.tsdf_params)
            for i in range(R + 1)
        ])
        packed = torch.where(alloc_en[:, None], packed, EMPTY_KEY).to(torch.int32).reshape(-1)
        allocate_packed(self.table, packed, compact=ALLOC_COMPACT * (R + 1))
        self._apply_tsdf_ops(depths, colors, poses, signs, img_of_op)

    def _tsdf_dispatch(self, store_slot=None, T_world=None, valid=None):
        """The frame's fused TSDF dispatch: the re-integration budget plus
        the current frame's fuse, as one kernel sweep. With no current frame
        (drain mode) only rows run."""
        rows = self._build_reintegrate_rows() if self.app.integration_enabled else []
        has_cur = store_slot is not None
        if not rows and not has_cur:
            return
        R = REINT_ROWS
        if not rows and has_cur:
            self._tsdf_fast(store_slot, T_world, bool(valid))
            return

        rows = rows[:R]
        self.reint_frames += 1
        self.reint_ops_total += sum(2 if mode == 2 else 1 for _f, mode, _To, _Tn in rows)
        eye = np.eye(4, dtype=np.float32)
        packed = np.zeros((R, 34), np.float32)
        packed[:, 2:18] = eye.reshape(-1)
        packed[:, 18:34] = eye.reshape(-1)
        for i, (f, mode, To, Tn) in enumerate(rows):
            packed[i, 0] = f
            packed[i, 1] = mode
            packed[i, 2:18] = To.reshape(-1)
            packed[i, 18:34] = Tn.reshape(-1)
        if has_cur:
            fid_cur, T_cur, cur_valid = store_slot, T_world, bool(valid)
        else:
            fid_cur, T_cur, cur_valid = 0, eye, False
        self._tsdf_rows(packed, fid_cur, T_cur, cur_valid)
        for f, mode, To, Tn in rows:
            if mode == 1:
                self.traj_manager.mark_deintegrated(f)
            elif mode == 2:
                self.traj_manager.mark_deintegrated(f)
                self.traj_manager.mark_integrated(f, Tn)
            elif mode == 3:
                self.traj_manager.mark_integrated(f, Tn)
        if self.app.garbage_collection_enabled and any(
            mode in (1, 2) for _, mode, _, _ in rows
        ):
            # de-integration may empty blocks; reclaim them (the fast path
            # never frees, so gc only runs on row frames)
            garbage_collect(self.table)

    def _build_reintegrate_rows(self):
        """Schedule at most ``max_frame_fixes`` de/re-integration ops
        (``TrajectoryManager::generateUpdateLists`` consumption)."""
        deint, reint, integ = self.traj_manager.generate_update_lists()
        if not (deint or reint or integ):
            return []
        budget = self.app.max_frame_fixes
        eye = np.eye(4, dtype=np.float32)
        # frames evicted from the archive cannot be re-integrated; mark them
        # handled so the scheduler stops re-ranking them
        for lst in (deint, reint, integ):
            for f in [x for x in lst if x >= self.frame_cap]:
                rec = self.traj_manager.records[f]
                if rec.optimized_transform is not None:
                    self.traj_manager.mark_integrated(f, rec.optimized_transform)
        deint = [f for f in deint if f < self.frame_cap]
        reint = [f for f in reint if f < self.frame_cap]
        integ = [f for f in integ if f < self.frame_cap]
        rows: List[tuple] = []  # (frame, mode, T_old, T_new)
        ops = 0
        hit_budget = False
        for f in deint:
            if ops >= budget:
                hit_budget = True
                break
            rec = self.traj_manager.records[f]
            if rec.integrated_transform is None:
                continue
            rows.append((f, 1, rec.integrated_transform, eye))
            ops += 1
        if not hit_budget:
            for f in reint:
                if ops + 2 > budget and ops > 0:
                    break
                rec = self.traj_manager.records[f]
                new_T = rec.optimized_transform
                has_old = rec.integrated_transform is not None
                ok_new = new_T is not None and np.isfinite(new_T).all()
                if has_old and ok_new:
                    rows.append((f, 2, rec.integrated_transform, new_T))
                elif has_old:
                    rows.append((f, 1, rec.integrated_transform, eye))
                elif ok_new:
                    rows.append((f, 3, eye, new_T))
                ops += 2
            for f in integ:
                if ops >= budget:
                    break
                rec = self.traj_manager.records[f]
                new_T = rec.optimized_transform
                if new_T is None or not np.isfinite(new_T).all():
                    continue
                rows.append((f, 3, eye, new_T))
                ops += 1
        return rows

    def _drain_reintegration(self):
        """The re-integration drain of ``finish()``: up to 10 row-only
        dispatches, until the scheduler has nothing left."""
        for _ in range(10):
            if not any(self.traj_manager.generate_update_lists()):
                break
            self._tsdf_dispatch()

    # ------------------------------------------------------------------
    def extract_mesh(self):
        from bundlefusion_tpu_torch.tsdf.marching_cubes import extract_mesh

        return extract_mesh(self.table, self.tsdf_params.voxel_size)

    def trajectory(self) -> np.ndarray:
        """Per-frame optimized camera-to-world matrices (nan = invalid)."""
        if not self.complete_traj:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack(self.complete_traj)
