"""Online BundleFusion engine: the full per-frame loop.

Port of ``bundlefusion_tpu/pipeline/online.py``:

- ``process_frame``: ``_frame_step`` (wire decode and frame archive, SIFT
  detect / describe, keypoint and dense-cache stores, matching against the
  submap's frames, the Kabsch -> surface-area -> dense-verify cascade, the
  correspondence store and the chained pose), the fused TSDF dispatch with
  its re-integration budget (``DepthSensing.cpp: reintegrate()`` then
  ``integrate()``), the per-frame splat render and, every ``submap_size``
  frames, the submap boundary;
- ``_submap_step``: local bundle adjustment of the submap (sparse + dense
  Gauss-Newton), dense verification of the solved submap, keyframe fusion,
  global matching of the new keyframe against all earlier ones, the global
  solve with up to ``max_prune_rounds`` max-residual pruning rounds,
  comprehensive frame invalidation, the window's rollover, and one packed
  read-back of everything the host scheduler consumes;
- the host scheduler: retirement of a boundary's pack (per-frame
  bookkeeping, keyframe validity, the retry list, the optimized complete
  trajectory pushed to the re-integration scheduler), revalidation of lost
  keyframes, behaviour past keyframe capacity;
- ``finish`` (trailing partial submap, extra global solves with the dense
  term at the end, the re-integration drain), ``warmup``, ``upload_frame``,
  ``trajectory``, ``extract_mesh``, ``render`` (raycast), ``save`` /
  ``load`` (``io/checkpoint.py``);
- host paging of cold TSDF blocks when ``app.streaming_enabled``: a sweep
  every ``streaming_every`` frames around the latest chained camera
  position, the paged keys the allocation skips, and a stream-in of the
  paged blocks a re-integration row could touch before it runs.

- the multi-device path (``mesh=``, a ``parallel.mesh.Mesh`` of more than
  one rank): one process per rank, each constructing the engine with the
  same arguments and calling the same methods with the same frames. Rank 0
  alone runs the per-frame path, the TSDF, the render and the boundary's
  local phase (submap solve, verification, keyframe fusion, rollover); it
  broadcasts what the JAX engine puts onto its mesh, and every rank then
  runs the boundary's global phase on its replica of the keyframe graph:
  keyframe-chunked global matching and the corr-chunked Gauss-Newton / PCG
  (``parallel/ba_sharded.py``), the pruning rounds and the composition.
  There is no collective on a frame that is not a boundary;
- the serialized device-time replay: every ``profile_every``-th frame after
  frame 0 drains the device and times each stage behind a device
  synchronisation into ``device_timing`` (``dev_frame_step``, ``dev_tsdf``
  or ``dev_tsdf_rows``, ``dev_render``, ``dev_submap``); ``timing`` takes a
  ``sync`` callable for the same on every frame;
- the span records (``trace`` / ``spans`` / ``counters``): while traced,
  every stage of ``timing`` and the spans between them (``process_frame``,
  ``upload_frame``, ``graph_launch``, ``reint_schedule``,
  ``garbage_collect``, ``boundary``, ``pack_read``, ``retire_one``,
  ``push_optimized``) are recorded with the host's waits for the card and
  the solver's Gauss-Newton counters (``utils/timing.py``), and the TSDF
  rows the sweeps listed are counted on the device; ``staleness`` says how
  far the map lags the optimized trajectory.

The JAX engine fuses each phase into one jitted program, donates its state
and retires a boundary's results one submap late to hide TPU dispatch
latency. Here the per-frame phase, ``_frame_step``, is the counterpart of
its compiled ``frame_step``: on the card it is captured once per window slot
as a CUDA graph (``_build_programs``, run by ``warmup`` or on a slot's
first frame) and each frame replays its slot's graph, which reads and writes
the window, the frame archive and the window's anchor pose in place, at the
addresses it was captured with, and waits for nothing. The fusion programs
(``_tsdf_fast``, ``_tsdf_rows`` and the render, the counterparts of the
compiled ``tsdf_fast`` / ``tsdf_rows`` / ``_render``) are captured the same
way, one graph each, and replayed on the frame graph's outputs: the pose and
validity never leave the card, the op signs are computed there, and a frame
that is not a boundary reads nothing back. The host decides each frame's
path and re-integration rows from its own scheduler alone. A boundary's
local bundle adjustment, its dense verification and its keyframe fusion
are one graph each too (captured at their first use, the warm-up's
boundary), the solve's Gauss-Newton early-out a mask on the card as in the
JAX engine's loop. Every other step runs eagerly on the engine's device,
state (the voxel table too) is updated in place, and a boundary's pack is
read back at the end of the frame that dispatched it. What the host
scheduler ends up with is the same.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from bundlefusion_tpu_torch import default_device
from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.lie import matrix_to_pose, pose_inverse, pose_to_matrix
from bundlefusion_tpu_torch.ops.image import (
    erode_depth,
    resample_bilinear,
    resample_nearest,
    rgb_to_intensity,
)
from bundlefusion_tpu_torch.ops.filters import DenseVerifyParams, dense_verify
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
    fuse_keyframe,
    match_and_filter,
)
from bundlefusion_tpu_torch.solver.dense_term import DenseTermParams
from bundlefusion_tpu_torch.solver.gn_pcg import (
    SolverParams,
    apply_pair_kill_sorted,
    apply_pair_kill_store,
    corr_counts_per_frame_sorted,
    guided_kill_mask,
    guided_kill_mask_store,
    invalidate_pair_sorted,
    max_residual,
    max_residual_sorted,
    presort_corrs,
    solve_bundle,
    solve_local,
    solve_sparse,
    solve_sparse_presorted,
)
from bundlefusion_tpu_torch.solver.residuals import (
    CorrStore,
    compact_corrs,
    corr_counts_per_frame,
    corr_store_from_numpy,
    create_corr_store,
    invalidate_image_pair,
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
from bundlefusion_tpu_torch.utils import (
    copy_into,
    host_reads,
    host_wait,
    owned_tensor,
    read_host,
    read_host_numpy,
)
from bundlefusion_tpu_torch.utils.timing import TimingLog, count, paused, stage

REINT_ROWS = 5  # max re-integration rows per frame (2 ops each, budget 10)
# the fused keyframe's fields, in the order a mesh boundary broadcasts them
FUSED_FIELDS = ("pos", "scale", "depth", "response", "valid", "desc")
CACHE_FIELDS = tuple(f.name for f in dataclasses.fields(DenseCache))
# the per-pair outputs of the global matching that a mesh boundary gathers
MATCH_FIELDS = ("pair_valid", "inlier_mask", "idx_cur", "idx_prev", "p_cur", "p_prev")


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


@dataclass
class GlobalState:
    """Device-resident keyframe-graph state (the reference's ``m_global``
    Bundler + per-submap solved trajectories for composition)."""

    keys: KeyframeStore        # [G] fused keyframe keypoints
    cache: DenseCache          # [G] keyframe dense cache
    corrs: CorrStore           # global EntryJ store
    poses: torch.Tensor        # [G, 6] keyframe poses (Lie [omega, t])
    local_traj: torch.Tensor   # [G, S, 4, 4] solved submap trajectories
    local_valid: torch.Tensor  # [G, S] bool per-frame validity after local solve


def global_state_from_numpy(arrays: dict, device) -> GlobalState:
    """A ``GlobalState`` from nested dicts of numpy arrays with the field
    names: ``keys`` / ``cache`` / ``corrs`` as their own constructors take
    them, ``poses`` [G, 6], ``local_traj`` [G, S, 4, 4], ``local_valid``
    [G, S]."""
    return GlobalState(
        keys=keyframe_store_from_numpy(arrays["keys"], device),
        cache=dense_cache_from_numpy(arrays["cache"], device),
        corrs=corr_store_from_numpy(arrays["corrs"], device),
        poses=owned_tensor(arrays["poses"], torch.float32, device),
        local_traj=owned_tensor(arrays["local_traj"], torch.float32, device),
        local_valid=owned_tensor(arrays["local_valid"], torch.bool, device),
    )


def _verify_local_pairs(local_world, lv, cache: DenseCache, intr, vp):
    """Dense-verify all adjacent submap frame pairs (``VerifyTrajectoryCU``).
    Returns (n_checked, n_failed) 0-d tensors."""
    T_rel = pose_inverse(local_world[1:]) @ local_world[:-1]
    keep, _, _ = dense_verify(
        T_rel,
        cache.depth[:-1], cache.campos[:-1], cache.normal[:-1],
        cache.depth[1:], cache.campos[1:], cache.normal[1:],
        intr, vp,
    )
    checked = lv[:-1] & lv[1:]
    return checked.sum(), (checked & ~keep).sum()


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


_CHECKSUM_CHUNK = 1 << 24  # words per step of a checksum (bounds its memory)
_WORD = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """[2] int64 checksum of a tensor's bits: the sum of its words and their
    position-weighted sum (wrapping), the same on any device for the same
    bits."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    words = flat.view(_WORD[flat.element_size()])
    out = torch.zeros(2, dtype=torch.int64, device=t.device)
    for s0 in range(0, words.shape[0], _CHECKSUM_CHUNK):
        w = words[s0:s0 + _CHECKSUM_CHUNK].to(torch.int64)
        pos = torch.arange(s0, s0 + w.shape[0], dtype=torch.int64, device=t.device) % 65521 + 1
        out += torch.stack([w.sum(), (w * pos).sum()])
    return out


def _cloned(state):
    """A copy of a (nested) dataclass of tensors, in storages of its own."""
    return type(state)(**{
        f.name: (v.clone() if isinstance(v, torch.Tensor) else _cloned(v))
        for f in dataclasses.fields(state) for v in (getattr(state, f.name),)})


class BundleFusion:
    """The engine. Feed RGB-D frames; read back poses / renders / mesh."""

    # Private switch: run ``_frame_step`` eagerly on the card instead of
    # replaying its captured graphs. Only for comparing the two, and for the
    # greedy filter's plain version, which reads the card and cannot be
    # captured.
    _eager_frame_step = False
    # Private switch: run the fusion programs (the TSDF dispatch's fast and
    # rows paths, the per-frame render) eagerly on the card instead of
    # replaying their captured graphs. Only for comparing the two.
    _eager_fusion = False

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
        lives on: the CUDA card unless the caller names another, or the
        mesh's device (with no card and no ``device`` this raises).

        ``mesh``: optional ``parallel.mesh.Mesh``; with more than one rank
        the boundary's global problem is computed over the ranks (see the
        module docstring) and the keyframe graph (``glob``,
        ``kf_valid_dev``) is replicated on every rank: each builds it from
        the same arguments, where the JAX engine places it with
        ``_shard_global``. Only rank 0 holds the
        window, the frame archive and the voxel table; its return values,
        ``trajectory()``, ``render`` and ``extract_mesh`` are the engine's
        results. On the other ranks ``process_frame`` returns ``{"pose":
        None, "valid": None}``, ``trajectory()`` holds the frames of the
        retired boundaries only, and the map methods raise. A 1-rank mesh
        takes the single-device path."""
        self.mesh = mesh
        self._use_mesh = mesh is not None and mesh.size > 1
        # rank 0 of a mesh, or the engine of a single device
        self._is_root = not self._use_mesh or mesh.rank == 0
        if self._use_mesh:
            n_dev = mesh.size
            G_eff = max_keyframes or bundling.max_num_images
            if G_eff % n_dev:
                raise ValueError(f"keyframe capacity {G_eff} must divide the mesh size {n_dev}")
            if bundling.max_global_corr % n_dev:
                raise ValueError(f"max_global_corr {bundling.max_global_corr} must divide the "
                                 f"mesh size {n_dev}")
        if device is None and mesh is not None:
            device = mesh.device
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
        # the map lives on rank 0 only
        self.table = (create_table(app.hash_key_capacity, app.hash_num_sdf_blocks, self.device)
                      if self._is_root else None)
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

        self.local_solver = SolverParams(
            num_gn=bundling.num_local_non_lin_iterations,
            num_pcg=bundling.num_local_lin_iterations,
            pcg_early_out=bundling.pcg_early_out,
            gn_early_out_delta=bundling.gn_early_out_delta,
            max_pairs=self.S * (self.S + 1) // 2 + 1,
        )
        self.global_solver = SolverParams(
            num_gn=bundling.num_global_non_lin_iterations,
            num_pcg=bundling.num_global_lin_iterations,
            pcg_early_out=bundling.pcg_early_out,
            gn_early_out_delta=bundling.gn_early_out_delta,
            max_pairs=min(bundling.solver_max_pairs, self.G * (self.G + 1) // 2 + 1),
            max_working_corrs=bundling.solver_max_working_corrs,
        )
        self.dense_term_params = DenseTermParams(
            dist_thresh=bundling.dense_dist_thresh,
            normal_thresh=bundling.dense_normal_thresh,
            color_thresh=bundling.dense_color_thresh,
            color_gradient_min=bundling.dense_color_gradient_min,
            depth_min=bundling.dense_depth_min,
            depth_max=bundling.dense_depth_max,
            overlap_subsample=bundling.dense_overlap_check_subsample_factor,
            overlap_min_hits=bundling.dense_overlap_min_hits,
            min_corr_per_pair=bundling.min_dense_corr_for_pair,
            max_pairs=64,
        )
        self.verify_params = dataclasses.replace(
            dense,
            err_thresh=bundling.verify_opt_err_thresh,
            corr_thresh=bundling.verify_opt_corr_thresh,
        )

        # ---- device-resident state ----
        self.local = self._fresh_local() if self._is_root else None
        self.glob = self._fresh_global()
        self.keyframe_valid = np.zeros(self.G, bool)
        # device twin of keyframe_valid: what the boundary computes with
        self.kf_valid_dev = torch.zeros((self.G,), dtype=torch.bool, device=self.device)
        self.num_keyframes = 0
        # the current submap's anchor pose; stays on the device
        self.submap_base = torch.eye(4, dtype=torch.float32, device=self.device)
        self.timing = TimingLog()
        # the per-frame program: window slot -> (CUDA graph, the kernel
        # launches it replays, the state addresses it was captured with),
        # its static buffers, and whether a capture is running
        self._graphs: dict = {}
        self._static: Optional[dict] = None
        self._capturing = False
        # the fusion programs: name ("fast", "rows", "render") -> (CUDA graph,
        # its kernel launches, the state addresses it was captured with, its
        # outputs), and how often one was captured again because the paged-key
        # array grew
        self._fusion: dict = {}
        self.fusion_recaptures = 0
        # the boundary's local programs: name ("solve", "verify", "fuse") ->
        # (CUDA graph, its kernel launches, the state addresses it was
        # captured with, its outputs)
        self._local_graphs: dict = {}
        # the serialized device-time replay (the reference's CUDATimer): every
        # ``profile_every``-th frame after frame 0 drains the device and
        # times each stage behind a synchronisation into ``device_timing``;
        # 0 turns it off
        self.profile_every = 0
        self.device_timing = TimingLog(sync=self._sync_device)

        # device-resident frame archive for re-integration (rank 0's)
        sub_len = self.S - 1
        self.frame_cap = min(app.max_frames, self.G * sub_len + self.S)
        self.store: Optional[FrameStore] = create_frame_store(
            self.frame_cap, self.intr_int.height, self.intr_int.width, self.device
        ) if self._is_root else None

        # packed per-submap readback layout (see ``_submap_step``)
        NF = self.G * sub_len
        self._off_lv = self.S * 16
        self._off_kf = self.S * 17
        self._off_flags = self.S * 17 + self.G
        self._off_comp = self._off_flags + 3
        self._off_ok = self._off_comp + NF * 16

        self.frame_idx = 0
        self.frame_valid: List[bool] = []
        self.sift_world: List[np.ndarray] = []     # per-frame chained estimate
        self.complete_traj: List[np.ndarray] = []  # per-frame optimized 4x4 (nan invalid)
        self._recorded_upto = 0                    # host bookkeeping high-water mark
        self._pending_submaps: List[tuple] = []    # FIFO of (g, pack) awaiting retirement
        # frame index of the current window's anchor + the buffer slot it
        # lives in (0 after a rollover; sub_len past keyframe capacity,
        # where boundaries stop rolling the buffer over)
        self._window_base = 0
        self._anchor_slot = 0
        # host paging of cold TSDF blocks (off by default, as in the
        # reference: paging conflicts with de-integration,
        # CUDASceneRepHashSDF.h:89-91). When on: the host block store and the
        # sorted device-side array of paged keys the allocation skips
        self.host_blocks = None
        self._blocked_dev = None
        if app.streaming_enabled and self._is_root:
            from bundlefusion_tpu_torch.tsdf.streaming import HostBlockStore

            self.host_blocks = HostBlockStore()
            self._blocked_dev = torch.full((app.streaming_blocked_cap,), EMPTY_KEY,
                                           dtype=torch.int32, device=self.device)
        self.traj_manager = TrajectoryManager(app.top_n_active, app.min_pose_dist_sqrt)
        # relocalization retry list (reference SIFTImageManager retry list +
        # Bundler::tryRevalidation): persistent and uncapped, oldest first,
        # one attempt per submap; the attempt counters are telemetry only
        self.retry_list: List[int] = []
        self.retry_attempts: dict = {}
        self.lost_count = 0
        # pair-cap overflow accounting, surfaced per retirement
        self.pairs_dropped_total = 0
        # per boundary: {"g", "prune_rounds", "host_reads"} (every read from
        # its revalidation attempt to its pack's read-back), and while the
        # stage log traces the boundary span's "span_ms", "wait_ms" and
        # "gn_steps" (None otherwise)
        self.boundary_stats: List[dict] = []
        # re-integration accounting: frames that dispatched the rows path +
        # total de/re-integration ops; per re-integrated revised frame, the
        # frames from the retirement that revised its pose to the sweep
        # that re-integrated it (``staleness``)
        self.reint_frames = 0
        self.reint_ops_total = 0
        self.reint_lags: List[int] = []
        # rows the TSDF sweeps listed, added on the device by every culled
        # dispatch (the fusion graphs too); ``trace`` reads its change
        self._rows_swept = torch.zeros((1,), dtype=torch.int64, device=self.device)
        # local Gauss-Newton steps whose update was applied (not masked by
        # the early-out), added on the device by every local solve, its
        # graph's replays too; ``trace`` reads its change
        self._local_gn_taken = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._trace_from = None
        self._trace_counts: dict = {}
        self.render_every = 1 if app.reconstruction_enabled else 0
        self.last_render = None

        self._splat = SplatParams(
            depth_min=app.render_depth_min,
            depth_max=app.render_depth_max,
            visible_cap=min(self.vis_cap, 8192),
        )
        if self._use_mesh:
            from bundlefusion_tpu_torch.parallel.ba_sharded import make_replicated_chunk_solver

            self._sharded_solve = make_replicated_chunk_solver(
                mesh, self.G, bundling.max_global_corr, self.global_solver)

    # ------------------------------------------------------------------
    def _sync_device(self) -> None:
        """Wait for the engine's device (nothing to wait for on the CPU), as
        a timed wait (``utils.host_wait``)."""
        if self.device.type == "cuda":
            host_wait(lambda: torch.cuda.synchronize(self.device), counted=False, what="syncs")

    def _device_stage(self, name: str, on: bool):
        """A stage of the serialized replay (``device_timing``), or nothing."""
        return self.device_timing.stage(name) if on else nullcontext()

    def _need_map(self, what: str) -> None:
        if not self._is_root:
            raise RuntimeError(f"{what}: rank {self.mesh.rank} of the mesh holds no map; "
                               f"rank 0 does")

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

    def _fresh_global(self) -> GlobalState:
        G, S, dev = self.G, self.S, self.device
        return GlobalState(
            keys=create_keyframe_store(G, self.bundling.max_num_keys_per_image, dev),
            cache=create_dense_cache(G, self.intr_cache.height, self.intr_cache.width, dev),
            corrs=create_corr_store(self.bundling.max_global_corr, dev),
            poses=torch.zeros((G, 6), dtype=torch.float32, device=dev),
            local_traj=torch.zeros((G, S, 4, 4), dtype=torch.float32, device=dev),
            local_valid=torch.zeros((G, S), dtype=torch.bool, device=dev),
        )

    def _rollover_local(self) -> None:
        """The window rollover at a submap boundary: the overlap frame (slot
        S-1: keys, cache, validity) becomes slot 0 of a fresh window with
        identity relative poses and an empty correspondence store.

        The new window is written into the window's own storages, which a
        captured frame graph reads by address; ``self.local`` becomes a new
        ``LocalState`` over them, and the object that was live keeps the
        finished window, in copies."""
        live, new = self.local, self._fresh_local()
        last = self.S - 1
        copy_cache_frame(new.cache, 0, live.cache, last)
        for f in dataclasses.fields(KeyframeStore):
            getattr(new.keys, f.name)[0] = getattr(live.keys, f.name)[last]
        new.valid[0] = live.valid[last]
        self.local = LocalState(**{f.name: getattr(live, f.name)
                                   for f in dataclasses.fields(live)})
        kept = _cloned(live)
        copy_into(self.local, new)
        for f in dataclasses.fields(live):
            setattr(live, f.name, getattr(kept, f.name))

    def _frame_step(self, depth_u16, color_u8, cur_slot: int, store_slot):
        """One frame: archive -> detect -> store -> match/filter -> chain,
        on ``self.local``, ``self.store`` and ``self.submap_base``, all
        updated in place.

        ``cur_slot`` is the frame's position in the submap window,
        ``store_slot`` its slot in the frame archive (a host int, or an
        int64 index tensor of one element on the device). Returns (T_world
        [4, 4], valid bool []) as tensors on the device; nothing is read
        back here and, on the card, nothing waits for it, so the whole step
        can be captured as a CUDA graph (:meth:`_run_frame_step`). TSDF work
        happens in the separate ``_tsdf_dispatch``.
        """
        # a capture times nothing: its stages would time the recording
        loc, log = self.local, None if self._capturing else self.timing
        with stage(log, "time_sensor_process"):
            intensity_sift, depth_sift, depth_int, color_int = self._archive_frame(
                depth_u16, color_u8, store_slot)
        kp = detect_and_describe(intensity_sift, depth_sift, self.sift_cfg, timing=log)
        with stage(log, "time_store"):
            store_keypoints(loc.keys, cur_slot, kp)
            store_cache_frame(loc.cache, cur_slot, depth_int, color_int, self.intr_cache)

        if cur_slot > 0:
            mf = match_and_filter(cur_slot, loc.keys, loc.cache, self.intr_sift,
                                  self.intr_cache, self.frontend_local, timing=log)
            with stage(log, "time_misc"):
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

    # ------------------------------------------------------------------
    # the per-frame program: _frame_step captured per window slot (the
    # counterpart of the JAX engine's jitted frame_step)
    def _graphs_on(self) -> bool:
        """Whether ``_frame_step`` replays captured graphs: on the card, on
        the rank that runs the per-frame path, unless switched off."""
        return self.device.type == "cuda" and self._is_root and not self._eager_frame_step

    def _state_ptrs(self) -> tuple:
        """Addresses of every tensor the captured programs read or write
        that outlives them: the window, the frame archive, the anchor pose
        (``_frame_step``) and the voxel table (the fusion programs)."""
        ts = [self.submap_base, self.local.rel, self.local.valid,
              self.store.depth_mm, self.store.color]
        for part in (self.local.keys, self.local.cache, self.local.corrs, self.table):
            ts += [getattr(part, f.name) for f in dataclasses.fields(part)]
        return tuple(t.data_ptr() for t in ts)

    def _fusion_ptrs(self) -> tuple:
        """``_state_ptrs`` and, last, the paged-key array's address (0 with
        paging off): the one that may move, when the array grows."""
        blocked = self._blocked_dev
        return self._state_ptrs() + (0 if blocked is None else blocked.data_ptr(),)

    def _build_programs(self) -> None:
        """Capture the engine's programs (the counterpart of the JAX
        engine's ``_build_programs``) against its own state, as ``warmup``
        has it: ``_frame_step`` for every window slot 0..S-1 (with
        :meth:`_graphs_on`), each first run once eagerly on a zero frame on
        the capture stream (kernel libraries, library handles and
        workspaces exist before the capture), then captured; the state is
        reset in place after. Then the fusion programs (with
        :meth:`_fusion_graphs_on`), each behind one eager run on inputs that
        change nothing: an invalid current frame, the (zero) scratch slot
        of the archive, re-integration rows that all skip."""
        st = self._static_buffers()
        if self._graphs_on():
            st["depth"].zero_()
            st["color"].zero_()
            self._graphs.clear()
            # the zero frames are set-up work: the engine's stage log skips them
            log, self.timing = self.timing, TimingLog(enabled=False)
            try:
                for slot in range(self.S):
                    self._capture_slot(slot, self.frame_cap)
            finally:
                self.timing = log
            # the zero frames wrote the window and the archive's scratch slot
            copy_into(self.local, self._fresh_local())
            self.store.depth_mm.view(torch.int16)[self.frame_cap] = 0
            self.store.color[self.frame_cap] = 0
        if self._fusion_graphs_on():
            skip = np.zeros((REINT_ROWS, 34), np.float32)
            skip[:, 2:18] = skip[:, 18:34] = np.eye(4, dtype=np.float32).reshape(-1)
            self._set_fusion_inputs(self.frame_cap, np.eye(4, dtype=np.float32), False, skip)
            self._fusion.clear()
            for name in ("fast", "rows", "render"):
                self._capture_fusion(name)

    def _static_buffers(self) -> dict:
        """The programs' static inputs (one wire frame, the archive slot as
        a device index, the re-integration rows [R, 34]), static outputs of
        the frame program, which are the fusion programs' inputs (pose,
        validity), and on the card the capture stream and the graphs'
        shared memory pool; made once."""
        if self._static is None:
            h, w, dev = self.intr_input.height, self.intr_input.width, self.device
            self._static = {
                "depth": torch.zeros((h, w), dtype=torch.int16, device=dev),
                "color": torch.zeros((h, w, 3), dtype=torch.uint8, device=dev),
                "store_slot": torch.zeros((1,), dtype=torch.int64, device=dev),
                "T_world": torch.zeros((4, 4), dtype=torch.float32, device=dev),
                "valid": torch.zeros((), dtype=torch.bool, device=dev),
                "rows": torch.zeros((REINT_ROWS, 34), dtype=torch.float32, device=dev),
                "local_world": torch.zeros((self.S, 4, 4), dtype=torch.float32, device=dev),
            }
            if dev.type == "cuda":
                self._static.update(stream=torch.cuda.Stream(dev),
                                    pool=torch.cuda.graph_pool_handle())
        return self._static

    def _step_into_outputs(self, cur_slot: int) -> None:
        """``_frame_step`` from the static inputs into the static outputs."""
        st = self._static
        T_world, valid = self._frame_step(st["depth"], st["color"], cur_slot, st["store_slot"])
        st["T_world"].copy_(T_world)
        st["valid"].copy_(valid)

    def _capture(self, body, what: str):
        """Run ``body`` once eagerly on the capture stream (kernel libraries,
        library handles and workspaces then exist), then capture the same
        call as a CUDA graph (a capture runs nothing). A capture records the
        kernel launches without making them: they are taken off
        ``kernels.launch_counts`` and added back at each replay. Returns (the
        eager run's result, the graph, its launches, the captured call's
        result, which a replay rewrites). A failed capture raises; there is
        no eager fall-back."""
        from bundlefusion_tpu_torch import kernels

        st, dev = self._static, self.device
        side = st["stream"]
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            eager = body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.launch_counts)
        self._capturing = True
        try:
            # the capture runs nothing: the solver's step counters skip it
            with paused(), torch.cuda.graph(graph, pool=st["pool"], stream=side):
                out = body()
        except Exception as exc:
            raise RuntimeError(f"capturing {what} failed: something in it waits for the card "
                               f"or reads it back") from exc
        finally:
            self._capturing = False
            launched = {k: n - before.get(k, 0) for k, n in kernels.launch_counts.items()}
            kernels.launch_counts.update(before)
        return eager, graph, launched, out

    def _capture_slot(self, cur_slot: int, store_slot: int) -> None:
        """Run the frame in the static inputs through ``_frame_step`` once,
        eagerly, then capture the same step as slot ``cur_slot``'s graph."""
        self._static["store_slot"].fill_(store_slot)
        _, graph, launched, _ = self._capture(lambda: self._step_into_outputs(cur_slot),
                                              f"_frame_step for window slot {cur_slot}")
        self._graphs[cur_slot] = (graph, launched, self._state_ptrs())

    def _run_frame_step(self, depth_u16, color_u8, cur_slot: int, store_slot: int):
        """``_frame_step`` as ``process_frame`` runs it: on the card the
        frame is copied into the static inputs and slot ``cur_slot``'s graph
        is replayed (captured first, behind one eager run of this frame, if
        the slot has none yet); else eagerly. Returns (T_world [4, 4],
        valid bool []) on the device, tensors of their own."""
        if not self._graphs_on():
            return self._frame_step(depth_u16, color_u8, cur_slot, store_slot)
        from bundlefusion_tpu_torch import kernels

        st = self._static_buffers()
        if not isinstance(depth_u16, torch.Tensor):
            depth_u16, color_u8 = self.upload_frame(depth_u16, color_u8)
        st["depth"].copy_(depth_u16)
        st["color"].copy_(color_u8)
        entry = self._graphs.get(cur_slot)
        if entry is None:
            self._capture_slot(cur_slot, store_slot)
        else:
            graph, launched, ptrs = entry
            if ptrs != self._state_ptrs():
                raise RuntimeError("the window, the frame archive, the anchor pose or the "
                                   "voxel table was replaced after the frame graphs were "
                                   "captured: the engine updates them in place")
            st["store_slot"].fill_(store_slot)
            with self.timing.span("graph_launch"):
                graph.replay()
            for k, n in launched.items():
                kernels.launch_counts[k] += n
        return st["T_world"].clone(), st["valid"].clone()

    # ------------------------------------------------------------------
    # the boundary's local programs: the local solve, its dense verification
    # and the keyframe fusion of ``_submap_local``, one graph each
    def _local_body(self, name: str):
        """Local program ``name`` on the window: ``"solve"``, the window's
        bundle adjustment from its chained poses (:func:`solve_local`, which
        reads nothing back and adds the steps it applied to
        ``_local_gn_taken``), writes ``local_world`` [S, 4, 4] into its
        static buffer and returns it; ``"verify"`` returns the adjacent
        pairs checked and failed there; ``"fuse"`` returns the fused
        keyframe (``fused``), the window's dense-cache row 0 (``cache_row``)
        and ``pack_a`` [chained world S*16 | frame valid S]."""
        st, loc = self._static_buffers(), self.local
        if name == "solve":
            dense = (loc.cache, self.intr_cache, self.dense_term_params) \
                if self.bundling.use_local_dense else ()
            poses = solve_local(matrix_to_pose(loc.rel), loc.valid, loc.corrs,
                                self.local_solver, *dense, taken=self._local_gn_taken)
            return st["local_world"].copy_(pose_to_matrix(poses))
        if name == "verify":
            return _verify_local_pairs(st["local_world"], loc.valid, loc.cache,
                                       self.intr_cache, self.verify_params)
        # fuse the keyframe from the solved submap's feature tracks (anchor
        # frame 0; SIFTImageManager::fuseToGlobal)
        fused = fuse_keyframe(loc.keys, loc.corrs, st["local_world"], 0, self.intr_sift,
                              self.glob.keys.keys_per_frame)
        # the keyframe store holds bfloat16 descriptors: the same cast the
        # store's copy would make
        fused["desc"] = fused["desc"].to(torch.bfloat16)
        return {
            "fused": fused,
            # copies: the rollover writes the new window into slot 0
            "cache_row": {n: getattr(loc.cache, n)[0].clone() for n in CACHE_FIELDS},
            "pack_a": torch.cat([(self.submap_base @ loc.rel).reshape(-1),
                                 loc.valid.to(torch.float32)]),
        }

    def _run_local(self, name: str):
        """Local program ``name`` as a boundary runs it: on the card
        replayed from its graph (captured first, behind one eager run, if it
        has none), else eagerly. Returns its outputs: on a replay the
        graph's own tensors, which the next boundary's replay rewrites."""
        if not self._graphs_on():
            return self._local_body(name)
        from bundlefusion_tpu_torch import kernels

        entry = self._local_graphs.get(name)
        if entry is None:
            self._static_buffers()   # the capture stream and pool
            eager, graph, launched, out = self._capture(lambda: self._local_body(name),
                                                        f"the local program {name!r}")
            self._local_graphs[name] = (graph, launched, self._state_ptrs(), out)
            return eager
        graph, launched, ptrs, out = entry
        if ptrs != self._state_ptrs():
            raise RuntimeError("the window, the frame archive, the anchor pose or the voxel "
                               "table was replaced after the local programs were captured: "
                               "the engine updates them in place")
        graph.replay()
        for k, n in launched.items():
            kernels.launch_counts[k] += n
        return out

    # ------------------------------------------------------------------
    # the fusion programs: the TSDF dispatch's fast and rows paths and the
    # per-frame render, on the device's pose and validity (the counterparts
    # of the JAX engine's jitted tsdf_fast / tsdf_rows / _render)
    def _fusion_graphs_on(self) -> bool:
        """Whether the fusion programs replay captured graphs: on the card,
        on the rank that holds the map, unless switched off."""
        return self.device.type == "cuda" and self._is_root and not self._eager_fusion

    def _set_fusion_inputs(self, store_slot=None, T_world=None, valid=None,
                           rows=None) -> None:
        """Write one dispatch's inputs (those given) into the static buffers
        the fusion programs read: the archive slot (a host int, or a device index),
        the pose and validity (device tensors, copied unless they are the
        buffers themselves, as the frame program's outputs are; or host
        values) and the re-integration rows [R, 34] (host). Host values go
        to the card through pinned memory, with no wait; each copy gets a
        fresh pinned block from PyTorch's caching host allocator, which
        hands a block out again only once the copy that used it has run."""
        st = self._static_buffers()
        for key, val in (("store_slot", store_slot), ("T_world", T_world), ("valid", valid)):
            dst = st[key]
            if val is None:
                continue
            if isinstance(val, torch.Tensor):
                if val.data_ptr() != dst.data_ptr():
                    dst.copy_(val.reshape(dst.shape))
            elif key == "T_world":
                dst.copy_(self._pinned(np.asarray(val, np.float32)), non_blocking=True)
            else:
                dst.fill_(bool(val) if key == "valid" else int(val))
        if rows is not None:
            st["rows"].copy_(self._pinned(np.asarray(rows, np.float32)), non_blocking=True)

    def _pinned(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr))
        return host.pin_memory() if self.device.type == "cuda" else host

    def _fusion_body(self, name: str):
        """Fusion program ``name`` on the static inputs (the render returns
        its outputs)."""
        st = self._static
        if name == "fast":
            return self._tsdf_fast(st["store_slot"], st["T_world"], st["valid"])
        if name == "rows":
            return self._tsdf_rows(st["rows"], st["store_slot"], st["T_world"], st["valid"])
        return self._render(self.table, st["T_world"])

    def _capture_fusion(self, name: str):
        """Capture fusion program ``name`` behind one eager run of it (the
        call's real work); returns the eager run's result."""
        eager, graph, launched, out = self._capture(lambda: self._fusion_body(name),
                                                    f"the fusion program {name!r}")
        self._fusion[name] = (graph, launched, self._fusion_ptrs(), out)
        return eager

    def _run_fusion(self, name: str):
        """Fusion program ``name`` on the static inputs, as ``process_frame``
        runs it: on the card replayed from its graph (captured first, behind
        one eager run, if it has none, or again if the paged-key array grew
        since, counted in ``fusion_recaptures``); else eagerly. Returns the
        render's outputs (on a replay, the graph's own tensors)."""
        if not self._fusion_graphs_on():
            return self._fusion_body(name)
        from bundlefusion_tpu_torch import kernels

        entry = self._fusion.get(name)
        if entry is not None:
            ptrs = self._fusion_ptrs()
            if entry[2][:-1] != ptrs[:-1]:
                raise RuntimeError("the voxel table, the window, the frame archive or the "
                                   "anchor pose was replaced after the fusion graphs were "
                                   "captured: the engine updates them in place")
            if entry[2][-1] != ptrs[-1]:
                self.fusion_recaptures += 1
                entry = None
        if entry is None:
            return self._capture_fusion(name)
        graph, launched, _, out = entry
        with self.timing.span("graph_launch"):
            graph.replay()
        for k, n in launched.items():
            kernels.launch_counts[k] += n
        return out

    def _apply_tsdf_ops(self, depths, colors, poses, signs, img_of_op):
        """Fused multi-op TSDF update of ``self.table`` (in place).
        Ops apply sequentially; sign 0 is an exact no-op."""
        apply_tsdf_ops(self.table, depths, colors, poses, signs, img_of_op,
                       self.intr_int, self.tsdf_params, rows_swept=self._rows_swept)

    def _render(self, table, cam_to_world):
        return splat_render(table, self.intr_int, self._as_pose(cam_to_world),
                            self.tsdf_params, self._splat)

    def _render_frame(self, f: int, T_world):
        """The per-frame visualisation of ``process_frame``: splat the TSDF
        at the frame's pose (a device tensor, or a host pose) into
        ``last_render`` every ``render_every`` frames (the reference renders
        every frame). ``last_render`` is a copy: a replay rewrites the
        graph's outputs, not an earlier render."""
        if self.render_every and f % self.render_every == 0:
            self._set_fusion_inputs(T_world=T_world)
            out = self._run_fusion("render")
            self.last_render = {k: v.clone() for k, v in out.items()}

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

    def upload_frame(self, depth, color):
        """Start the host -> device upload of one input frame: compaction to
        the wire format, a pinned host buffer and a non-blocking copy, so
        frame i + 1 can upload while frame i computes (the analog of the
        reference's sensor thread). Returns a handle to pass to
        :meth:`process_frame` as ``depth`` (with ``color=None``)."""
        if not self._is_root:
            return None, None  # the other ranks of a mesh take no frames
        with self.timing.span("upload_frame", frame=self.frame_idx):
            depth_u16, color_u8 = self._to_wire(depth, color)
            d = torch.from_numpy(np.ascontiguousarray(depth_u16).view(np.int16))
            c = torch.from_numpy(np.ascontiguousarray(color_u8))
            if self.device.type == "cuda":
                d = d.pin_memory().to(self.device, non_blocking=True)
                c = c.pin_memory().to(self.device, non_blocking=True)
        return d, c

    def _store_slot(self, f: int) -> int:
        """Frame archive slot: frames beyond capacity land in the scratch
        slot (they become non-re-integrable)."""
        return f if f < self.frame_cap else self.frame_cap

    def _archive_frame(self, depth_u16, color_u8, store_slot: int):
        """The archive step of ``frame_step``: decode the wire frame (numpy
        arrays, or the handle's tensors from :meth:`upload_frame`), erode
        and resample it, archive it at integration resolution, and return
        (intensity_sift, depth_sift, depth_int, color_int) with the
        integration-res images DECODED from the archive, so a later
        de-integration subtracts bitwise-identical contributions."""
        if not isinstance(depth_u16, torch.Tensor):
            depth_u16, color_u8 = self.upload_frame(depth_u16, color_u8)
        # the depth codes travel as int16 (same bits)
        d_u16 = depth_u16.to(device=self.device, dtype=torch.int32) & 0xFFFF
        c_u8 = color_u8.to(self.device)
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
        scheduler (``TrajectoryManager::updateOptimizedTransform``), as
        revised at the last frame processed."""
        n = len(self.complete_traj)
        poses = np.stack(self.complete_traj) if n else np.zeros((0, 4, 4))
        valid = np.isfinite(poses).all(axis=(1, 2)) if n else np.zeros((0,), bool)
        self.traj_manager.update_optimized_transforms(poses, valid,
                                                      revision=max(self.frame_idx - 1, 0))

    # ------------------------------------------------------------------
    def _decode_frames(self, fids):
        return decode_frame(*load_frames(self.store, fids))

    def _tsdf_fast(self, store_slot, T_cur, valid):
        """Typical frame: the current frame's fuse — one allocation and one
        kernel sweep. ``store_slot`` (int64 [1]), ``T_cur`` [4, 4] and
        ``valid`` (bool []) are tensors on the device, as the reference's
        jitted ``tsdf_fast`` takes them: the sign is the validity, and
        nothing is read back."""
        d, c = self._decode_frames(store_slot.reshape(1))
        packed = candidate_keys(d[0], self.intr_int, T_cur, self.tsdf_params)
        allocate_packed(self.table, torch.where(valid, packed, EMPTY_KEY),
                        blocked=self._blocked_dev)
        self._apply_tsdf_ops(d, c, T_cur[None], valid.to(torch.float32).reshape(1),
                             torch.zeros((1,), dtype=torch.int32, device=self.device))

    def _tsdf_rows(self, rows, store_slot, T_cur, cur_valid):
        """Re-integration frame: up to R rows (de/re/int ops) plus the
        current frame's fuse, in one batched allocation and one kernel
        sweep. ``rows`` [R, 34] = fid | op | T_old flat | T_new flat (op: 0
        skip, 1 de-integrate, 2 de+re, 3 integrate), ``store_slot`` (int64
        [1]), ``T_cur`` and ``cur_valid`` are tensors on the device; the
        signs are computed there, as the reference's jitted ``tsdf_rows``
        computes them."""
        R = REINT_ROWS
        row_fids = rows[:, 0].to(torch.int64)
        row_ops = rows[:, 1].to(torch.int32)
        T_olds = rows[:, 2:18].reshape(R, 4, 4)
        T_news = rows[:, 18:34].reshape(R, 4, 4)
        fids = torch.cat([row_fids, store_slot.reshape(1)])
        depths, colors = self._decode_frames(fids)           # [R+1, ...]
        de_en = (row_ops == 1) | (row_ops == 2)
        re_en = (row_ops == 2) | (row_ops == 3)

        # ops: [de_0, re_0, de_1, re_1, ..., current]
        poses = torch.cat([torch.stack([T_olds, T_news], 1).reshape(2 * R, 4, 4), T_cur[None]])
        signs = torch.cat([
            torch.stack([-de_en.to(torch.float32), re_en.to(torch.float32)], 1).reshape(2 * R),
            cur_valid.to(torch.float32).reshape(1),
        ])
        img_of_op = torch.div(torch.arange(2 * R + 1, device=self.device), 2,
                              rounding_mode="floor").to(torch.int32)

        # batched allocation: re-integration targets + current frame, with
        # the dedup budget scaled so each frame keeps its own
        alloc_en = torch.cat([re_en, cur_valid.reshape(1)])
        alloc_T = torch.cat([T_news, T_cur[None]])
        packed = torch.stack([
            candidate_keys(depths[i], self.intr_int, alloc_T[i], self.tsdf_params)
            for i in range(R + 1)
        ])
        packed = torch.where(alloc_en[:, None], packed, EMPTY_KEY).to(torch.int32).reshape(-1)
        allocate_packed(self.table, packed, compact=ALLOC_COMPACT * (R + 1),
                        blocked=self._blocked_dev)
        self._apply_tsdf_ops(depths, colors, poses, signs, img_of_op)

    def _tsdf_dispatch(self, store_slot=None, T_world=None, valid=None):
        """The frame's fused TSDF dispatch: the re-integration budget plus
        the current frame's fuse, as one kernel sweep. With no current frame
        (drain mode) only rows run. ``T_world`` / ``valid`` are device
        tensors (the frame program's outputs) or host values; the host
        decides the path and the rows from its own scheduler alone, and
        reads nothing of the card."""
        log = self.timing
        with log.span("reint_schedule"):
            rows = self._build_reintegrate_rows() if self.app.integration_enabled else []
        has_cur = store_slot is not None
        if not rows and not has_cur:
            return
        if rows and self.app.streaming_enabled and len(self.host_blocks):
            # stream-in before re-integration: a de- or re-integration over a
            # paged region would under-subtract (the allocation skips paged
            # keys); the reference's chunk grid does the same
            # (CUDASceneRepChunkGrid.h:142-210)
            self._stream_in_for_rows(rows)
        R = REINT_ROWS
        if not rows:
            self._set_fusion_inputs(store_slot, T_world, valid)
            self._run_fusion("fast")
            return

        rows = rows[:R]
        self.reint_frames += 1
        self.reint_ops_total += sum(2 if mode == 2 else 1 for _f, mode, _To, _Tn in rows)
        eye = np.eye(4, dtype=np.float32)
        with log.span("reint_schedule"):
            packed = np.zeros((R, 34), np.float32)
            packed[:, 2:18] = eye.reshape(-1)
            packed[:, 18:34] = eye.reshape(-1)
            for i, (f, mode, To, Tn) in enumerate(rows):
                packed[i, 0] = f
                packed[i, 1] = mode
                packed[i, 2:18] = To.reshape(-1)
                packed[i, 18:34] = Tn.reshape(-1)
        if has_cur:
            self._set_fusion_inputs(store_slot, T_world, valid, packed)
        else:
            self._set_fusion_inputs(0, eye, False, packed)
        self._run_fusion("rows")
        tm = self.traj_manager
        with log.span("reint_schedule"):
            for f, mode, To, Tn in rows:
                if mode == 1:
                    tm.mark_deintegrated(f)
                elif mode == 2:
                    tm.mark_deintegrated(f)
                    tm.mark_integrated(f, Tn)
                elif mode == 3:
                    tm.mark_integrated(f, Tn)
                revised = tm.take_revised(f)
                if revised is not None:
                    self.reint_lags.append(self.frame_idx - revised)
        if self.app.garbage_collection_enabled and any(
            mode in (1, 2) for _, mode, _, _ in rows
        ):
            # de-integration may empty blocks; reclaim them (the fast path
            # never frees, so gc only runs on row frames)
            with log.span("garbage_collect"):
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
    def _compose(self, gposes, kf_valid):
        """complete[k * sub_len + r] = kf_world[k] @ local[k][r]
        (``updateTrajectoryCU``: invalid -> nan). Returns ([G * sub_len, 4,
        4], [G * sub_len] bool) on the device."""
        sub_len = self.S - 1
        kf_world = pose_to_matrix(gposes)
        comp = torch.einsum("kij,ksjl->ksil", kf_world, self.glob.local_traj[:, :sub_len])
        ok = kf_valid[:, None] & self.glob.local_valid[:, :sub_len]
        comp = torch.where(ok[..., None, None], comp, torch.nan)
        return comp.reshape(self.G * sub_len, 4, 4), ok.reshape(self.G * sub_len)

    def _pack_tail(self) -> torch.Tensor:
        """Tail pack for the trailing partial submap: [chained world S*16 |
        frame valid S]."""
        world = self.submap_base @ self.local.rel
        return torch.cat([world.reshape(-1), self.local.valid.to(torch.float32)])

    def _submap_step(self, g: int, last_world) -> torch.Tensor:
        """Submap boundary: local solve -> verify -> fuse keyframe ->
        rollover (the local phase, rank 0), then insert the keyframe ->
        global match -> global solve (+ max-residual pruning) -> compose
        (the global phase, every rank), on ``self.local`` / ``self.glob`` /
        ``self.kf_valid_dev`` / ``self.submap_base``. On a mesh rank 0
        broadcasts the local phase's outputs with ``submap_base`` and
        ``last_world`` between the two (the other ranks pass None as
        ``last_world``).

        Returns ``pack``, the flat float32 host-readback buffer [chained
        world S*16 | frame valid S | kf_valid G | submap_ok, matched,
        pairs_dropped | composed trajectory G*sub_len*16 | composed valid
        G*sub_len]: everything the host scheduler consumes, fetched in one
        transfer per submap."""
        log, dev, S = self.timing, self.device, self.S
        reads0, kabsch_reads, prune_rounds = host_reads["count"], 0, 0
        p = self._submap_local(last_world) if self._is_root else None
        if self._use_mesh:
            with stage(log, "time_submap_broadcast"):
                p = self._broadcast_boundary(p)
        self._insert_keyframe(g, p)

        kf_valid = self.kf_valid_dev
        matched = torch.ones((), dtype=torch.bool, device=dev)
        pairs_dropped = torch.zeros((), dtype=torch.int32, device=dev)
        if g > 0:
            glob_phase = self._submap_global if self._use_mesh else self._global_single
            matched, pairs_dropped, kabsch_reads, prune_rounds = glob_phase(g)

        with stage(log, "time_submap_pack"):
            # the overlap frame's solved pose is the next window's base
            kf_world_g = pose_to_matrix(self.glob.poses[g])
            submap_ok = p["submap_ok"]
            overlap_world = torch.where(submap_ok, kf_world_g @ p["local_world"][S - 1],
                                        p["last_world"])
            comp, comp_ok = self._compose(self.glob.poses, kf_valid)
            pack = torch.cat([
                p["pack_a"],
                kf_valid.to(torch.float32),
                torch.stack([submap_ok.to(torch.float32), matched.to(torch.float32),
                             pairs_dropped.to(torch.float32)]),
                comp.reshape(-1),
                comp_ok.to(torch.float32),
            ])
            self.submap_base.copy_(overlap_world)
        self.boundary_stats.append({
            "g": g, "prune_rounds": prune_rounds,
            # + 1: the pack's read-back at retirement
            "host_reads": host_reads["count"] - reads0 + kabsch_reads + 1,
            "span_ms": None, "wait_ms": None, "gn_steps": None,
        })
        return pack

    def _submap_local(self, last_world) -> dict:
        """The boundary's local phase (``self.local`` -> the keyframe row):
        the submap's bundle adjustment, its dense verification, keyframe
        fusion, the window's rollover. Returns what the global phase takes:
        ``fused`` (keyframe fields), ``cache_row`` (dense-cache fields),
        ``local_world`` [S, 4, 4], ``lv_out`` [S], ``submap_ok`` [],
        ``base`` (the window's anchor pose), ``last_world`` and ``pack_a``
        [chained world S*16 | frame valid S]."""
        b, log, loc = self.bundling, self.timing, self.local
        lv = loc.valid
        with stage(log, "time_submap_local_solve"):
            # sparse (+ dense depth term, dense weight ramp iter + 1,
            # SBA.cpp:28-38); a replay enqueues every Gauss-Newton step, each
            # an LU
            if self._graphs_on() and "solve" in self._local_graphs:
                n = self.local_solver.num_gn
                count("local_graph_replays")
                count("gn_steps", n)
                count("lu_steps", n)
            else:
                count("local_eager_solves")
            local_world = self._run_local("solve")

        submap_ok = lv[0] & (lv.sum() >= 2)
        if b.use_local_verify:
            # a solved submap failing dense verification is invalid
            # (VerifyTrajectoryCU path, Bundler.cpp:259-273)
            with stage(log, "time_submap_verify"):
                n_checked, n_failed = self._run_local("verify")
                submap_ok = submap_ok & ((n_checked == 0) | (n_failed <= n_checked // 3))

        with stage(log, "time_submap_fuse"):
            out = {
                **self._run_local("fuse"),
                "local_world": local_world,
                "lv_out": lv & submap_ok,
                "submap_ok": submap_ok,
                "base": self.submap_base,
                "last_world": self._as_pose(last_world),
            }
            # rollover: the overlap frame becomes slot 0 of the fresh submap
            self._rollover_local()
        return out

    def _boundary_tensors(self, p: Optional[dict]) -> List[torch.Tensor]:
        """The local phase's outputs as the flat list a mesh boundary
        broadcasts; without ``p`` (ranks other than 0), empty tensors of the
        same shapes and dtypes, taken from the keyframe graph."""
        glob, dev = self.glob, self.device
        if p is not None:
            return ([p["fused"][n] for n in FUSED_FIELDS]
                    + [p["cache_row"][n] for n in CACHE_FIELDS]
                    + [p[n] for n in ("local_world", "lv_out", "submap_ok", "base",
                                      "last_world", "pack_a")])
        return ([torch.empty_like(getattr(glob.keys, n)[0]) for n in FUSED_FIELDS]
                + [torch.empty_like(getattr(glob.cache, n)[0]) for n in CACHE_FIELDS]
                + [torch.empty_like(glob.local_traj[0]), torch.empty_like(glob.local_valid[0]),
                   torch.empty((), dtype=torch.bool, device=dev),
                   torch.empty((4, 4), dtype=torch.float32, device=dev),
                   torch.empty((4, 4), dtype=torch.float32, device=dev),
                   torch.empty((self.S * 17,), dtype=torch.float32, device=dev)])

    def _broadcast_boundary(self, p: Optional[dict]) -> dict:
        """Rank 0's local-phase outputs on every rank, in one broadcast."""
        from bundlefusion_tpu_torch.parallel.mesh import broadcast_tensors

        ts = broadcast_tensors(self.mesh, self._boundary_tensors(p))
        nf, nc = len(FUSED_FIELDS), len(CACHE_FIELDS)
        rest = dict(zip(("local_world", "lv_out", "submap_ok", "base", "last_world", "pack_a"),
                        ts[nf + nc:]))
        return {"fused": dict(zip(FUSED_FIELDS, ts[:nf])),
                "cache_row": dict(zip(CACHE_FIELDS, ts[nf:nf + nc])), **rest}

    def _insert_keyframe(self, g: int, p: dict) -> None:
        """Write boundary ``g``'s keyframe into the keyframe graph: solved
        window, fused keys, dense-cache row, anchor pose, validity."""
        glob, submap_ok = self.glob, p["submap_ok"]
        glob.local_traj[g] = p["local_world"]
        glob.local_valid[g] = p["lv_out"]
        gk = glob.keys
        for name in FUSED_FIELDS:
            getattr(gk, name)[g] = p["fused"][name]
        gk.frame_valid[g] = submap_ok
        for name, row in p["cache_row"].items():
            getattr(glob.cache, name)[g] = row
        glob.poses[g] = matrix_to_pose(p["base"])
        self.kf_valid_dev[g] = submap_ok

    def _global_single(self, g: int):
        """The global phase of boundary ``g`` > 0 on one device: match the
        new keyframe against all earlier ones, solve the keyframe graph
        (one sort, then pruning rounds that flip validity bits), invalidate
        keyframes left without correspondences. Returns (matched,
        pairs_dropped, Kabsch host reads, prune rounds)."""
        b, log, dev, G = self.bundling, self.timing, self.device, self.G
        glob, kf_valid = self.glob, self.kf_valid_dev
        prune_rounds = 0
        with stage(log, "time_submap_global_match"):
            mf = match_and_filter(g, glob.keys, glob.cache, self.intr_sift, self.intr_cache,
                                  self.frontend_global)
            matched = mf["pair_valid"].any()
            # an unmatched keyframe has no inliers: nothing is appended
            add_to_residuals(glob.corrs, mf, g, torch.arange(G, dtype=torch.int32, device=dev))
            kf_valid[g] = kf_valid[g] & matched
        ks = torch.arange(G, device=dev)
        kv = kf_valid & (ks <= g)
        prev_poses = glob.poses  # trajectory before this solve
        with stage(log, "time_submap_global_solve"):
            # ONE sort per boundary; the pruning rounds below only flip
            # validity bits in the presorted working set
            prob = presort_corrs(glob.corrs, G, self.global_solver)
            sposes = solve_sparse_presorted(prev_poses, kv, prob, self.global_solver)
            pairs_dropped = prob.sc.dropped

        # residual pruning, several rounds per solve
        # (SBA::removeMaxResidualCUDA, SBA.cpp:169-204: the reference
        # prunes once per solve but solves every frame). A round that
        # prunes nothing leaves the state as it is, so the loop ends.
        with stage(log, "time_submap_prune"):
            for _ in range(b.max_prune_rounds):
                mr, fa, fb = max_residual_sorted(sposes, prob)
                pair = self._prune_pair(mr, fa, fb)
                if pair is None:
                    break
                prune_rounds += 1
                invalidate_image_pair(glob.corrs, *pair)
                prob = invalidate_pair_sorted(prob, *pair)
                if b.use_guided_remove:
                    # NEW_GUIDED_REMOVE: when badly off, also remove
                    # long-range pairs of the newest keyframe whose
                    # residual is high now AND was > 1.5x higher under
                    # the previous trajectory (a bad loop closure)
                    killed = guided_kill_mask(sposes, prev_poses, prob, g, mr, G)
                    apply_pair_kill_store(glob.corrs, killed, G)
                    prob = apply_pair_kill_sorted(prob, killed, G)
                sposes = solve_sparse_presorted(prev_poses, kv, prob, self.global_solver)

        # comprehensive frame invalidation: valid keyframes left without
        # correspondences after pruning lose their pose
        # (CheckForInvalidFramesCU); counts over the presorted working
        # set, into which the prune kills are mirrored
        if b.use_comprehensive_frame_invalidation:
            counts = corr_counts_per_frame_sorted(prob, G)
            kf_valid &= (counts > 0) | (ks == 0) | (ks > g)
        glob.poses = sposes
        return matched, pairs_dropped, mf["kabsch_host_reads"], prune_rounds

    def _prune_pair(self, mr, fa, fb):
        """The image pair a pruning round removes, as host ints, or None
        when the largest residual is within ``opt_max_res_thresh``."""
        mr_h, fa_h, fb_h = read_host(torch.stack([mr, fa.to(mr.dtype), fb.to(mr.dtype)]))
        if not (mr_h > self.bundling.opt_max_res_thresh and fa_h >= 0 and fb_h >= 0):
            return None
        return int(fa_h), int(fb_h)

    def _match_chunk(self, g: int) -> dict:
        """Global matching over the mesh: this rank runs the cascade of
        keyframe ``g`` against its ``G / n`` keyframe slots, and the per-pair
        outputs are all-gathered in slot order."""
        from bundlefusion_tpu_torch.parallel.mesh import all_gather

        glob, mesh = self.glob, self.mesh
        Gl = self.G // mesh.size
        mf = match_and_filter(g, glob.keys, glob.cache, self.intr_sift, self.intr_cache,
                              self.frontend_global,
                              slots=range(mesh.rank * Gl, (mesh.rank + 1) * Gl))
        out = {f: all_gather(mesh, mf[f]) for f in MATCH_FIELDS}
        out.update(cur_slot=g, num_keys_per_frame=mf["num_keys_per_frame"],
                   kabsch_host_reads=mf["kabsch_host_reads"])
        return out

    def _submap_global(self, g: int):
        """The global phase of boundary ``g`` > 0 on every rank of the mesh
        (the global branch of the JAX engine's ``submap_global``; its
        keyframe insert is :meth:`_insert_keyframe`, its composition the end
        of :meth:`_submap_step`): keyframe-chunked matching, the
        corr-chunked solve, pruning rounds that re-solve the store,
        comprehensive invalidation. Every decision here reads replicated
        values, so all ranks take the same branches. Returns (matched,
        pairs_dropped, Kabsch host reads, prune rounds)."""
        b, log, dev, G = self.bundling, self.timing, self.device, self.G
        glob, kf_valid = self.glob, self.kf_valid_dev
        prune_rounds = 0
        with stage(log, "time_submap_global_match"):
            mf = self._match_chunk(g)
            matched = mf["pair_valid"].any()
            add_to_residuals(glob.corrs, mf, g, torch.arange(G, dtype=torch.int32, device=dev))
            kf_valid[g] = kf_valid[g] & matched
        ks = torch.arange(G, device=dev)
        kv = kf_valid & (ks <= g)
        prev_poses = glob.poses
        with stage(log, "time_submap_global_solve"):
            sposes, pairs_dropped = self._sharded_solve(prev_poses, kv, glob.corrs)
        with stage(log, "time_submap_prune"):
            for _ in range(b.max_prune_rounds):
                mr, ci = max_residual(sposes, glob.corrs)
                pair = self._prune_pair(mr, glob.corrs.img_i[ci], glob.corrs.img_j[ci])
                if pair is None:
                    break
                prune_rounds += 1
                invalidate_image_pair(glob.corrs, *pair)
                if b.use_guided_remove:
                    killed = guided_kill_mask_store(sposes, prev_poses, glob.corrs, g, mr, G)
                    apply_pair_kill_store(glob.corrs, killed, G)
                sposes, _ = self._sharded_solve(prev_poses, kv, glob.corrs)
        if b.use_comprehensive_frame_invalidation:
            counts = corr_counts_per_frame(glob.corrs, G)
            kf_valid &= (counts > 0) | (ks == 0) | (ks > g)
        glob.poses = sposes
        return matched, pairs_dropped, mf["kabsch_host_reads"], prune_rounds

    def replicas_agree(self) -> bool:
        """Whether every rank holds the same bits of the keyframe graph
        (poses, ``kf_valid``, the corr store, the keyframe stores and
        dense cache, the solved windows): one all-reduce of per-tensor
        checksums. All ranks must call it; True without a mesh."""
        if not self._use_mesh:
            return True
        from bundlefusion_tpu_torch.parallel.mesh import all_reduce

        glob = self.glob
        tensors = [self.kf_valid_dev, glob.poses, glob.local_traj, glob.local_valid]
        for part in (glob.keys, glob.cache, glob.corrs):
            tensors += [getattr(part, f.name) for f in dataclasses.fields(part)]
        sums = torch.stack([_checksum(t) for t in tensors]).reshape(-1)
        both = all_reduce(self.mesh, torch.cat([sums, -sums]), op=torch.distributed.ReduceOp.MAX)
        n = sums.shape[0]
        return bool(torch.equal(both[:n], sums) and torch.equal(-both[n:], sums))

    # ------------------------------------------------------------------
    def warmup(self) -> float:
        """Build the CUDA kernels and run every path of the engine once,
        before the first frame, against the engine's own still-empty state:
        frame step, both TSDF variants, garbage collection, render, a submap
        boundary with its global branch, the revalidation match, the
        ``finish`` solves and the composition. What a timed run would
        otherwise pay at its first frame or boundary (kernel builds, library
        handles, first-call set-up) is paid here. On the card the boundary
        captures the local programs (their first use), and then
        ``_frame_step`` is captured once per window slot and the three
        fusion programs once each (``_build_programs``).
        A zero frame contributes no TSDF blocks, no correspondences and no
        keyframe validity; the window is reset in place and the keyframe
        graph replaced by a fresh one at the end, so the state is a fresh
        engine's. On a mesh every rank calls it (the boundary's collectives
        run once); rank 0 alone runs the per-frame paths. Returns elapsed
        seconds."""
        assert self.frame_idx == 0, "warmup() must run before the first frame"
        t0 = time.perf_counter()
        dev = self.device
        T_dev = None
        if self._is_root:
            if dev.type == "cuda":
                from bundlefusion_tpu_torch import kernels

                kernels.build_all()
            h, w = self.intr_input.height, self.intr_input.width
            T_dev, valid_dev = self._frame_step(np.zeros((h, w), np.uint16),
                                                np.zeros((h, w, 3), np.uint8), 0, 0)
            # zero depth -> no candidate blocks: the TSDF / gc warmups change nothing
            slot = torch.zeros((1,), dtype=torch.int64, device=dev)
            self._tsdf_fast(slot, T_dev, valid_dev)
            packed = np.zeros((REINT_ROWS, 34), np.float32)
            packed[:, 2:18] = packed[:, 18:34] = np.eye(4, dtype=np.float32).reshape(-1)
            self._tsdf_rows(torch.as_tensor(packed, device=dev), slot, T_dev, valid_dev)
            garbage_collect(self.table)
            self._render(self.table, T_dev)
        self._submap_step(1, T_dev)
        # revalidation path: match + append against an all-invalid store
        glob = self.glob
        glob.keys.frame_valid[0] = True
        mf = match_and_filter(0, glob.keys, glob.cache, self.intr_sift, self.intr_cache,
                              self.frontend_global)
        add_to_residuals(glob.corrs, mf, 0, torch.arange(self.G, dtype=torch.int32, device=dev))
        # finish() path: standalone global solves + composition
        kfv = self.kf_valid_dev
        self._solve_at_end(kfv, dense=False)
        if self.bundling.use_global_dense_at_end:
            self._solve_at_end(kfv, dense=True)
        self._compose(glob.poses, kfv)
        if self._is_root:
            self._pack_tail()
        self._sync_device()
        if self._is_root:
            copy_into(self.local, self._fresh_local())
        self.glob = self._fresh_global()
        self.kf_valid_dev.zero_()
        self.submap_base.copy_(torch.eye(4, dtype=torch.float32, device=dev))
        if self._graphs_on() or self._fusion_graphs_on():
            self._build_programs()
            self._sync_device()
        self.timing.reset()
        self.boundary_stats.clear()
        self.reint_lags.clear()
        self._local_gn_taken.zero_()
        self.last_render = None
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def process_frame(self, depth, color=None):
        """Process one input-resolution RGB-D frame.

        Args:
          depth: [H, W] float32 meters (or uint16 mm) at input resolution,
            or the handle returned by :meth:`upload_frame` (then ``color``
            must be None).
          color: [H, W, 3] float32 in [0, 1] (or uint8).

        Returns dict: ``pose`` (4x4, cam-to-world estimate), ``valid``, as
        tensors on the engine's device (None on the mesh's ranks other than
        0, which take part in the boundaries only).
        """
        f = self.frame_idx
        log = self.timing
        log.frame = f
        # submap slot (with one-frame overlap): frame k*(S-1) is slot S-1 of
        # submap k-1 AND slot 0 of submap k
        sub_len = self.S - 1
        slot = f % sub_len
        is_boundary = f > 0 and slot == 0
        cur_slot = sub_len if is_boundary else slot  # position in current buffer
        # serialized device-time replay frame: drain the device first, so
        # each stage's synchronised time below is that stage's alone
        prof = self.profile_every > 0 and f > 0 and f % self.profile_every == 0
        with log.span("process_frame"):
            if prof:
                self._sync_device()

            with log.stage("time_solve"):
                self._retire_submap()
                if is_boundary and self.num_keyframes >= self.G and self._is_root:
                    # past keyframe capacity: no rollover will happen, and this
                    # frame's frame step will overwrite the anchor slot; record
                    # the finishing window's chained poses first
                    self._record_window_tail(f)

            T_world_dev = valid_dev = None
            if self._is_root:
                T_world_dev, valid_dev = self._frame_tsdf_render(f, depth, color, cur_slot, prof)

            # the boundary's span: its step and, at the end of this frame, the
            # retirement of its pack
            n_stats = len(self.boundary_stats)
            with log.span("boundary") if is_boundary else nullcontext() as boundary:
                if is_boundary:
                    with log.stage("time_submap_step"):
                        with self._device_stage("dev_submap", prof):
                            dispatched = self._dispatch_submap(T_world_dev)
                    self._window_base = f
                    self._anchor_slot = 0 if dispatched else sub_len

                self.frame_idx += 1
                # the boundary's pack is read back at once (the JAX engine
                # waits for a later frame to hide the transfer)
                with log.stage("time_solve"):
                    self._retire_submap()
            if boundary is not None and len(self.boundary_stats) > n_stats:
                rec = boundary.record
                self.boundary_stats[-1].update(
                    span_ms=1e-6 * (rec["t1_ns"] - rec["t0_ns"]),
                    wait_ms=1e-6 * rec["wait_incl_ns"],
                    gn_steps=rec["counters_incl"].get("gn_steps", 0))
        return {"pose": T_world_dev, "valid": valid_dev}

    def _frame_tsdf_render(self, f: int, depth, color, cur_slot: int, prof: bool):
        """Rank 0's per-frame path of ``process_frame``: frame step, the
        fused TSDF dispatch, the render, the paging sweep. Returns (T_world,
        valid) on the device."""
        with self.timing.stage("time_frame_step"):
            depth_dev, color_dev = depth if color is None else self.upload_frame(depth, color)
            store_slot = self._store_slot(f)
            with self._device_stage("dev_frame_step", prof):
                T_world_dev, valid_dev = self._run_frame_step(depth_dev, color_dev, cur_slot,
                                                              store_slot)
        # the fusion programs read the pose and validity on the device: from
        # the frame graph's outputs themselves when it replays, so nothing is
        # read back and nothing copied between the programs
        T_world, valid = ((self._static["T_world"], self._static["valid"]) if self._graphs_on()
                          else (T_world_dev, valid_dev))

        # fused TSDF dispatch: re-integration budget + current frame's fuse
        # in one kernel sweep (reference order: reintegrate() then
        # integrate(), DepthSensing.cpp:854-902 + :1047)
        with self.timing.stage("time_re_integrate"):
            if self.app.integration_enabled:
                if prof:
                    # the replay keeps the rows (re-integration) dispatches
                    # apart: they cost several times the plain fuse
                    rows_before = self.reint_frames
                    self._sync_device()
                    t0 = time.perf_counter()
                    self._tsdf_dispatch(store_slot, T_world, valid)
                    self._sync_device()
                    self.device_timing.add(
                        "dev_tsdf_rows" if self.reint_frames > rows_before else "dev_tsdf",
                        time.perf_counter() - t0)
                else:
                    self._tsdf_dispatch(store_slot, T_world, valid)

        if self.render_every and f % self.render_every == 0:
            with self.timing.stage("time_visualize"):
                with self._device_stage("dev_render", prof):
                    self._render_frame(f, T_world)

        # host paging sweep (opt-in): far blocks out, returning blocks in
        if self.app.streaming_enabled and f > 0 and f % self.app.streaming_every == 0:
            self._stream_update()
        return T_world_dev, valid_dev

    # ------------------------------------------------------------------
    def _stream_update(self):
        """One host paging sweep around the latest chained camera position:
        returning blocks in, far blocks out, then the device-side paged-key
        array refreshed (``isSDFBlockStreamedOut`` analog)."""
        from bundlefusion_tpu_torch.tsdf.streaming import stream_in, stream_out

        if not self.sift_world:
            return  # no recorded pose yet to centre the radius on
        campos = np.asarray(self.sift_world[-1])[:3, 3]
        vs = self.app.sdf_voxel_size
        r = self.app.streaming_radius
        stream_in(self.table, self.host_blocks, campos, r, vs)
        stream_out(self.table, self.host_blocks, campos, r, vs)
        self._refresh_blocked_dev()

    def _stream_in_for_rows(self, rows):
        """Page in every host block that a pending re-integration row's old
        or new frustum could touch (conservative 8-corner test), then
        refresh the paged-key array."""
        from bundlefusion_tpu_torch.tsdf.streaming import paged_keys_in_frustum, stream_in_keys

        poses = []
        for _f, mode, To, Tn in rows:
            if mode in (1, 2):
                poses.append(To)
            if mode in (2, 3):
                poses.append(Tn)
        keys = paged_keys_in_frustum(self.host_blocks, poses, self.intr_int, self.tsdf_params,
                                     self.app.integration_height, self.app.integration_width)
        if len(keys):
            stream_in_keys(self.table, self.host_blocks, keys)
            self._refresh_blocked_dev()

    def _refresh_blocked_dev(self):
        """Rebuild the sorted device-side paged-key array from the host
        store, in place. It grows (doubling) rather than truncating: a
        dropped key would let the allocation re-create that block empty,
        forking it from its host copy, which a later stream-in would
        overwrite. A grown array is a new tensor, and the fusion programs,
        which read it by address, are captured again at their next use."""
        cap = self._blocked_dev.shape[0]
        n = len(self.host_blocks.blocks)
        while n > cap:
            cap *= 2
        arr = np.full((cap,), EMPTY_KEY, np.int32)
        if n:
            arr[:n] = np.sort(np.fromiter(self.host_blocks.blocks.keys(), np.int64)
                              .astype(np.int32))
        if cap == self._blocked_dev.shape[0]:
            self._blocked_dev.copy_(torch.from_numpy(arr))
        else:
            self._blocked_dev = torch.as_tensor(arr, device=self.device)

    # ------------------------------------------------------------------
    def _flush_pending(self):
        """Retire everything in flight (end of stream / before evaluation)."""
        self._retire_submap()
        if self._recorded_upto < self.frame_idx and self._is_root:
            # trailing frames of the current (partial) window
            self._record_window_tail(self.frame_idx)

    def _record_window_tail(self, end_frame: int):
        """Record frames [recorded_upto, end_frame) from the live local
        buffer (one small transfer). Handles both the normal trailing
        partial submap and the past-capacity windows where boundaries stop
        rolling the buffer over (the anchor then sits at slot ``sub_len``,
        not slot 0)."""
        if self._recorded_upto >= end_frame:
            return
        S = self.S
        sub_len = S - 1
        tail = read_host_numpy(self._pack_tail(), counted=False)
        world = tail[: S * 16].reshape(S, 4, 4)
        lv = tail[S * 16:] > 0.5
        base = self._window_base
        for f in range(self._recorded_upto, end_frame):
            s = self._anchor_slot if f == base else f - base
            assert 0 <= s <= sub_len, (f, base, self._anchor_slot)
            self._record_frame(f, world[s], bool(lv[s]))
        self._recorded_upto = end_frame

    def _dispatch_submap(self, last_world_dev) -> bool:
        """Local solve -> keyframe fusion -> global match -> global solve ->
        rollover (``OnlineBundler::process``); the pack waits in
        ``_pending_submaps`` for :meth:`_retire_submap`. Returns False once
        keyframe capacity is reached."""
        g = self.num_keyframes  # submap index == keyframe index
        if g >= self.G:
            return False  # capacity reached (reference caps s_maxNumImages)

        # relocalization attempt BEFORE the solve so revalidated corrs join
        # this submap's global solve (tryRevalidation, Bundler.cpp:306-352);
        # its reads are the boundary's too
        reads0 = host_reads["count"]
        self._try_revalidation()
        reads_before = host_reads["count"] - reads0

        # periodic corr-store compaction: residual pruning / frame
        # invalidation only MARK corrs dead, so long runs leak append
        # capacity; reclaiming every 64 submaps keeps the cursor bounded by
        # the live count (not on a mesh, as in the JAX engine)
        if g > 0 and g % 64 == 0 and not self._use_mesh:
            compact_corrs(self.glob.corrs)

        pack = self._submap_step(g, last_world_dev)
        self.boundary_stats[-1]["host_reads"] += reads_before
        self.num_keyframes += 1
        self._pending_submaps.append((g, pack))
        return True

    def _retire_submap(self):
        """Consume the packed readbacks of dispatched submaps, in order: each
        pack read back, retired, and the optimized trajectory it brings pushed
        to the re-integration scheduler."""
        log = self.timing
        while self._pending_submaps:
            g, pack = self._pending_submaps.pop(0)
            with log.span("pack_read"):
                pack = read_host_numpy(pack, counted=False)
            with log.span("retire_one"):
                self._retire_one(g, pack)
            with log.span("push_optimized"):
                self._push_optimized_to_manager()

    def _retire_one(self, g: int, pack: np.ndarray):
        """Per-frame host bookkeeping, keyframe validity, the lost-keyframe
        retry queue and the optimized complete trajectory from one pack."""
        S = self.S
        sub_len = S - 1

        world = pack[: self._off_lv].reshape(S, 4, 4)
        lv = pack[self._off_lv: self._off_kf] > 0.5
        prev_kf_valid = self.keyframe_valid
        self.keyframe_valid = pack[self._off_kf: self._off_flags] > 0.5
        matched = pack[self._off_flags + 1] > 0.5
        # silent-cap accounting: pairs beyond solver_max_pairs were dropped
        # from this global solve (the reference silently truncates too)
        self.pairs_dropped_total += int(pack[self._off_flags + 2])
        # keyframes that LOST validity during this solve (residual pruning +
        # comprehensive frame invalidation) queue for relocalization retries
        for k in np.where(prev_kf_valid[: g + 1] & ~self.keyframe_valid[: g + 1])[0]:
            k = int(k)
            if k not in self.retry_list:
                self.retry_list.append(k)
        comp = pack[self._off_comp: self._off_ok].reshape(-1, 4, 4)
        comp_ok = pack[self._off_ok:] > 0.5

        # per-frame bookkeeping for the frames this submap covers
        base = g * sub_len
        last = min(base + sub_len, self.frame_idx - 1)
        for f in range(self._recorded_upto, last + 1):
            self._record_frame(f, world[f - base], bool(lv[f - base]))
        self._recorded_upto = max(self._recorded_upto, last + 1)

        if g > 0 and not matched:
            # keyframe not matched: tracking lost for this submap -> queue
            # for relocalization retries
            self.lost_count += 1
            self.retry_list.append(g)

        # optimized trajectory for all solved submaps (invalid -> nan)
        m = min(len(self.complete_traj), (g + 1) * sub_len, comp.shape[0])
        nanT = np.full((4, 4), np.nan, np.float32)
        for i in range(m):
            self.complete_traj[i] = comp[i].astype(np.float32) if comp_ok[i] else nanT

    def _try_revalidation(self):
        """One relocalization attempt per submap: re-match the oldest lost
        keyframe against all valid keyframes (``tryRevalidation``,
        Bundler.cpp:306-352). Success restores the keyframe and appends its
        correspondences; failure re-queues (persistent, uncapped)."""
        if not self.retry_list:
            return
        k = self.retry_list.pop(0)
        self.retry_attempts[k] = self.retry_attempts.get(k, 0) + 1
        glob = self.glob
        # temporarily mark the keyframe's stored features active for matching
        glob.keys.frame_valid[k] = True
        mf = match_and_filter(k, glob.keys, glob.cache, self.intr_sift, self.intr_cache,
                              self.frontend_global)
        # only pairs against currently-valid keyframes count
        pair_valid = np.asarray(read_host(mf["pair_valid"]), bool) & self.keyframe_valid[: self.G]
        if pair_valid.any():
            add_to_residuals(glob.corrs, mf, k,
                             torch.arange(self.G, dtype=torch.int32, device=self.device))
            self.keyframe_valid[k] = True
            self.kf_valid_dev[k] = True
        else:
            glob.keys.frame_valid[k] = False
            self.retry_list.append(k)

    def _update_complete_trajectory(self, n_solved: Optional[int] = None):
        """complete[f] = keyframe_world[k] @ local[k][r], read back in one
        transfer: used by ``finish`` after its extra solves (the per-frame
        loop gets this from the boundary's pack). Only the frames of the
        first ``n_solved`` submaps are overwritten; later frames keep the
        chained estimate."""
        if n_solved is None:
            n_solved = self.num_keyframes
        kfv = torch.as_tensor(self.keyframe_valid, device=self.device)
        comp, ok = self._compose(self.glob.poses, kfv)
        flat = read_host_numpy(torch.cat([comp.reshape(-1), ok.to(torch.float32)]),
                               counted=False)
        n_comp = comp.shape[0]
        comp, ok = flat[: n_comp * 16].reshape(-1, 4, 4), flat[n_comp * 16:] > 0.5
        m = min(len(self.complete_traj), n_solved * (self.S - 1), n_comp)
        nanT = np.full((4, 4), np.nan, np.float32)
        for f in range(m):
            self.complete_traj[f] = comp[f] if ok[f] else nanT
        self._push_optimized_to_manager()

    def _solve_at_end(self, kv: torch.Tensor, dense: bool) -> torch.Tensor:
        """One of ``finish``'s global solves of the keyframe graph (sparse,
        or with the dense term): on a mesh rank 0 solves and broadcasts the
        poses, so the replicas stay identical. Returns the poses."""
        if not self._is_root:
            poses = torch.empty_like(self.glob.poses)
        elif dense:
            poses = self._solve_dense_at_end(kv)
        else:
            poses, _ = solve_sparse(self.glob.poses, kv, self.glob.corrs, self.global_solver)
        if self._use_mesh:
            from bundlefusion_tpu_torch.parallel.mesh import broadcast_tensors

            poses, = broadcast_tensors(self.mesh, [poses])
        return poses

    def _solve_dense_at_end(self, kv: torch.Tensor):
        """The final global pass with dense depth weight 15 and the
        photometric weight (USE_GLOBAL_DENSE_AT_END, OnlineBundler.cpp:177-189;
        denseColor SBA.cpp:28-38). Returns the poses."""
        with stage(self.timing, "time_finish_dense_solve"):
            gposes, _ = solve_bundle(
                self.glob.poses, kv, self.glob.corrs, self.glob.cache, self.intr_cache,
                self.global_solver, self.dense_term_params,
                dense_weights=[15.0] * self.global_solver.num_gn,
                w_color=self.bundling.dense_color_at_end_weight,
            )
        return gposes

    def finish(self, extra_solves: Optional[int] = None):
        """End of sequence: solve the trailing partial submap, run extra
        global solves and drain the re-integration queue
        (``numSolveFramesBeforeExit``)."""
        with stage(self.timing, "time_finish"):
            self._flush_pending()
            sub_len = self.S - 1
            if self.frame_idx % sub_len != 1 and self.frame_idx > 0:
                # trailing partial submap: the window is already sized; solve it
                self._dispatch_submap(self._as_pose(self.sift_world[-1]) if self._is_root
                                      else None)
                self._retire_submap()
            n_extra = (
                extra_solves
                if extra_solves is not None
                else max(self.app.num_solve_frames_before_exit // 10, 1)
            )
            for it in range(n_extra):
                if self.num_keyframes > 1:
                    kv = self.keyframe_valid.copy()
                    kv[self.num_keyframes:] = False
                    kv = torch.as_tensor(kv, device=self.device)
                    self.glob.poses = self._solve_at_end(
                        kv, dense=self.bundling.use_global_dense_at_end and it == n_extra - 1)
                self._update_complete_trajectory()
                if self._is_root:
                    self._drain_reintegration()

    # ------------------------------------------------------------------
    def render(self, cam_to_world, raycast_params=None):
        """Raycast the TSDF from a camera pose at integration resolution:
        ``depth``, ``points``, ``normals``, ``color`` on the engine's device
        (the per-frame render of ``process_frame`` is the splat)."""
        from bundlefusion_tpu_torch.tsdf.raycast import RaycastParams, raycast

        self._need_map("render")
        rp = raycast_params or RaycastParams(
            ray_increment_factor=self.app.sdf_ray_increment_factor,
            depth_min=self.app.render_depth_min,
            depth_max=self.app.render_depth_max,
        )
        return raycast(self.table, self.intr_int, self._as_pose(cam_to_world),
                       self.tsdf_params, rp)

    def extract_mesh(self):
        from bundlefusion_tpu_torch.tsdf.marching_cubes import extract_mesh

        self._need_map("extract_mesh")
        return extract_mesh(self.table, self.tsdf_params.voxel_size)

    def trajectory(self) -> np.ndarray:
        """Per-frame optimized camera-to-world matrices (nan = invalid)."""
        if not self.complete_traj:
            return np.zeros((0, 4, 4), np.float32)
        return np.stack(self.complete_traj)

    # ------------------------------------------------------------------
    def trace(self, on: bool, profiler_ranges: bool = False) -> None:
        """Start or stop the stage log's span records (``timing``; with
        ``profiler_ranges``, each span is also a ``bf.<name>`` range of
        ``torch.profiler``). Stopping reads, once, the TSDF rows the sweeps
        listed since the start (``counters``); starting reads nothing. Call
        it between frames: neither waits for a frame's work, but the stop's
        read does."""
        log = self.timing
        if on and not log.tracing:
            self._trace_from = (self._device_counts(), self.frame_idx)
        elif not on and log.tracing and self._trace_from is not None:
            counts0, frame0 = self._trace_from
            rows, taken = read_host(self._device_counts() - counts0, counted=False)
            self._trace_counts = {"frames": self.frame_idx - frame0, "tsdf_rows": int(rows),
                                  "local_gn_taken": int(taken)}
            self._trace_from = None
        log.trace(on, profiler_ranges)

    def _device_counts(self) -> torch.Tensor:
        """The counters kept on the device, in one new tensor: the TSDF rows
        listed, the local Gauss-Newton steps applied."""
        return torch.cat([self._rows_swept, self._local_gn_taken])

    def spans(self) -> List[dict]:
        """The span records closed since the last call (``utils.timing``),
        as plain dicts; forgotten here."""
        return self.timing.spans()

    def counters(self) -> dict:
        """The last traced stretch's ``frames`` and ``tsdf_rows`` (rows the
        TSDF sweeps listed: culled dispatches only, so 0 on the CPU), and the
        map's staleness now (:meth:`staleness`)."""
        return {**self._trace_counts, **self.staleness()}

    def staleness(self) -> dict:
        """How far the map lags the optimized trajectory, in frames: of the
        frames re-integrated so far after a pose revision, how many
        (``reintegrated``) and the mean and largest number of frames from
        the retirement that revised the pose to the sweep that re-integrated
        it (``lag_frames_mean``, ``lag_frames_max``); and the frames whose
        revised pose still waits (``backlog``), with the age of the oldest
        (``backlog_oldest_frames``). Host state only; no read."""
        tm = self.traj_manager
        if self.app.integration_enabled:
            tm.generate_update_lists()   # brings the waiting list up to date
        lags, waiting = self.reint_lags, tm.revised_at
        return {
            "reintegrated": len(lags),
            "lag_frames_mean": sum(lags) / len(lags) if lags else None,
            "lag_frames_max": max(lags) if lags else None,
            "backlog": len(waiting),
            "backlog_oldest_frames": (max(self.frame_idx - 1, 0) - min(waiting.values())
                                      if waiting else None),
        }

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Checkpoint the complete engine state (voxel table with its
        host-paged blocks, keyframe and correspondence stores, frame
        archive, trajectories, scheduler) into one ``.npz``. Resume with
        :meth:`BundleFusion.load`. On a mesh every rank calls it: rank 0
        writes the file and the others wait until it is written."""
        from bundlefusion_tpu_torch.io.checkpoint import save_engine

        if self._is_root:
            save_engine(self, path)
        if self._use_mesh:
            from bundlefusion_tpu_torch.parallel.mesh import barrier

            barrier(self.mesh)

    @staticmethod
    def load(path: str, mesh=None, device=None) -> "BundleFusion":
        """An engine restored from a checkpoint written by :meth:`save` or
        by the JAX package's ``BundleFusion.save``, on ``device`` (the CUDA
        card unless the caller names another, or the mesh's device). A
        checkpoint holds no topology: pass ``mesh`` to restore it onto a
        mesh (every rank calls this and reads the file)."""
        from bundlefusion_tpu_torch.io.checkpoint import load_engine

        return load_engine(path, mesh=mesh, device=device)
