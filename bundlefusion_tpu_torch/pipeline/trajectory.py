"""Trajectory manager: re-integration scheduling after pose updates.

Mirrors the reference ``TrajectoryManager`` (TrajectoryManager.{h,cpp}):
per-frame records of the transform each frame was *integrated* with vs the
latest *optimized* transform; after every optimization the pose-delta metric
(translation + 2x rotation angle, ``generateUpdateLists`` :66-75) ranks
frames, the top-N (s_topNActive=30) above threshold go to the re-integrate
list, newly invalidated frames to the de-integrate list, revalidated frames
to the integrate list; the reconstruction loop consumes at most
s_maxFrameFixes=10 operations per frame (``DepthSensing.cpp:854-902``).

Host-side (numpy) by design: this is scheduling logic over a few thousand
scalars — the reference also runs it on CPU. A copy of
``bundlefusion_tpu/pipeline/trajectory.py`` (no torch needed), plus the
map's staleness: ``revised_at`` holds, for each integrated frame whose
optimized pose is past the threshold, the ``revision`` (the caller's frame
index, given with each optimized trajectory) at which it first got there;
the caller takes a frame out when its row re-integrates it
(``take_revised``), and a frame back under the threshold leaves by itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional

import numpy as np


class FrameState(IntEnum):
    NOT_INTEGRATED = 0
    INTEGRATED = 1
    INVALID = 2          # marked invalid (never integrated or de-integrated)


@dataclass
class FrameRecord:
    state: FrameState = FrameState.NOT_INTEGRATED
    integrated_transform: Optional[np.ndarray] = None  # 4x4 used at fusion time
    optimized_transform: Optional[np.ndarray] = None   # latest solver output


def pose_delta_np(Ta: np.ndarray, Tb: np.ndarray, rot_scale: float = 2.0) -> float:
    dt = float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]))
    dR = Ta[:3, :3].T @ Tb[:3, :3]
    ang = float(np.arccos(np.clip((np.trace(dR) - 1.0) * 0.5, -1.0, 1.0)))
    return dt + rot_scale * ang


class TrajectoryManager:
    def __init__(self, top_n_active: int = 30, min_pose_dist: float = 0.0):
        self.records: List[FrameRecord] = []
        self.top_n_active = top_n_active
        self.min_pose_dist = min_pose_dist
        self.revision = 0
        self.revised_at: dict = {}

    def add_frame(self, frame_idx: int, integrated_transform: Optional[np.ndarray]):
        """Register a frame at integration time (None = not integrated /
        invalid at tracking time)."""
        while len(self.records) <= frame_idx:
            self.records.append(FrameRecord())
        rec = self.records[frame_idx]
        if integrated_transform is not None and np.isfinite(integrated_transform).all():
            rec.state = FrameState.INTEGRATED
            rec.integrated_transform = integrated_transform.copy()
        else:
            rec.state = FrameState.NOT_INTEGRATED

    def update_optimized_transforms(self, poses: np.ndarray, valid: np.ndarray,
                                    revision: int = 0):
        """Ingest the latest optimized complete trajectory
        (``updateOptimizedTransform``, TrajectoryManager.cpp:34-43), made at
        ``revision``."""
        self.revision = revision
        n = min(len(self.records), len(poses))
        for i in range(n):
            rec = self.records[i]
            if valid[i] and np.isfinite(poses[i]).all():
                rec.optimized_transform = poses[i].copy()
                if rec.state == FrameState.INVALID:
                    # revalidated
                    rec.state = (
                        FrameState.INTEGRATED
                        if rec.integrated_transform is not None
                        else FrameState.NOT_INTEGRATED
                    )
            else:
                rec.optimized_transform = None
                if rec.state == FrameState.INTEGRATED:
                    rec.state = FrameState.INVALID

    def generate_update_lists(self):
        """Returns (deintegrate_list, reintegrate_list, integrate_list) of
        frame indices (``generateUpdateLists``, TrajectoryManager.cpp:45-108).

        - de-integrate: integrated frames that became invalid.
        - re-integrate: integrated frames whose optimized pose moved by more
          than ``min_pose_dist``, top ``top_n_active`` by delta descending.
        - integrate: frames with a valid optimized pose never integrated
          (revalidated or previously skipped).
        """
        deint, reint_scored, integ = [], [], []
        for i, rec in enumerate(self.records):
            if rec.state == FrameState.INVALID and rec.integrated_transform is not None:
                deint.append(i)
            elif rec.state == FrameState.INTEGRATED and rec.optimized_transform is not None:
                d = pose_delta_np(rec.integrated_transform, rec.optimized_transform)
                if d > self.min_pose_dist and d > 1e-7:
                    reint_scored.append((d, i))
            elif (
                rec.state == FrameState.NOT_INTEGRATED
                and rec.optimized_transform is not None
            ):
                integ.append(i)
        reint_scored.sort(reverse=True)
        self._note_revised([i for _, i in reint_scored])
        reint = [i for _, i in reint_scored[: self.top_n_active]]
        return deint, reint, integ

    def _note_revised(self, above: List[int]) -> None:
        """``revised_at`` for the frames ``above`` the threshold now: a new
        one is stamped with the current revision, one no longer above is
        dropped."""
        pend = self.revised_at
        for i in above:
            if i not in pend:
                pend[i] = self.revision
        if len(pend) > len(above):
            keep = set(above)
            for i in [i for i in pend if i not in keep]:
                del pend[i]

    def take_revised(self, frame_idx: int) -> Optional[int]:
        """The revision at which ``frame_idx``'s pose went past the
        threshold, if it is waiting; it waits no more."""
        return self.revised_at.pop(frame_idx, None)

    def mark_deintegrated(self, frame_idx: int):
        rec = self.records[frame_idx]
        rec.integrated_transform = None
        rec.state = FrameState.NOT_INTEGRATED

    def mark_integrated(self, frame_idx: int, transform: np.ndarray):
        rec = self.records[frame_idx]
        rec.integrated_transform = transform.copy()
        rec.state = FrameState.INTEGRATED

    def num_integrated(self) -> int:
        return sum(1 for r in self.records if r.state == FrameState.INTEGRATED)
