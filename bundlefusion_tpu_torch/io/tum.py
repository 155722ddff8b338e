"""TUM RGB-D dataset reader (fr1/desk etc.).

Port of ``bundlefusion_tpu/io/tum.py`` (numpy; ``cv2`` for the PNG images,
imported where it is used).

The reference evaluates against TUM sequences converted to ``.sens``; for
completeness this reads the native TUM layout: ``depth/*.png`` (16-bit,
depth/5000 m), ``rgb/*.png``, ``groundtruth.txt`` (t tx ty tz qx qy qz qw),
``depth.txt``/``rgb.txt`` index files; associates by nearest timestamp.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics

# TUM Freiburg-1 default intrinsics
FR1_INTRINSICS = CameraIntrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640, height=480)
FR2_INTRINSICS = CameraIntrinsics(fx=520.9, fy=521.0, cx=325.1, cy=249.7, width=640, height=480)
FR3_INTRINSICS = CameraIntrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480)
DEPTH_SCALE = 5000.0


def _read_index(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _quat_to_mat(tx, ty, tz, qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )
    T[:3, 3] = [tx, ty, tz]
    return T


def read_groundtruth(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            out.append((v[0], _quat_to_mat(*v[1:8])))
    return out


@dataclass
class TumSequence:
    root: str
    depth_files: List[Tuple[float, str]]
    rgb_files: List[Tuple[float, str]]
    gt: List[Tuple[float, np.ndarray]]
    intrinsics: CameraIntrinsics

    def __len__(self) -> int:
        return len(self.depth_files)

    def frame(self, i: int):
        """(depth [H,W] float32 m, color [H,W,3] float32, gt_pose or None)."""
        import cv2

        td, dpath = self.depth_files[i]
        d = cv2.imread(os.path.join(self.root, dpath), cv2.IMREAD_UNCHANGED)
        depth = d.astype(np.float32) / DEPTH_SCALE
        depth = np.where(depth > 0, depth, np.nan)
        # associate nearest rgb
        tr = np.array([t for t, _ in self.rgb_files])
        j = int(np.argmin(np.abs(tr - td)))
        img = cv2.imread(os.path.join(self.root, self.rgb_files[j][1]))
        color = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        pose = None
        if self.gt:
            tg = np.array([t for t, _ in self.gt])
            k = int(np.argmin(np.abs(tg - td)))
            if abs(tg[k] - td) < 0.05:
                pose = self.gt[k][1]
        return depth, color, pose


def load_tum(root: str, intrinsics: Optional[CameraIntrinsics] = None) -> TumSequence:
    if intrinsics is None:
        name = os.path.basename(root.rstrip("/"))
        if "freiburg2" in name or "fr2" in name:
            intrinsics = FR2_INTRINSICS
        elif "freiburg3" in name or "fr3" in name:
            intrinsics = FR3_INTRINSICS
        else:
            intrinsics = FR1_INTRINSICS
    gt_path = os.path.join(root, "groundtruth.txt")
    return TumSequence(
        root=root,
        depth_files=_read_index(os.path.join(root, "depth.txt")),
        rgb_files=_read_index(os.path.join(root, "rgb.txt")),
        gt=read_groundtruth(gt_path) if os.path.exists(gt_path) else [],
        intrinsics=intrinsics,
    )
