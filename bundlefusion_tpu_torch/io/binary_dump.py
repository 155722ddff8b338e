"""Binary-dump sequence reader/writer (BinaryDumpReader analog).

Port of ``bundlefusion_tpu/io/binary_dump.py`` (numpy only).

The reference's ``BinaryDumpReader`` (BinaryDumpReader.cpp, s_sensorIdx=3)
deserializes an mLib ``CalibratedSensorData`` blob: calibration (depth +
color intrinsics/extrinsics), resolutions, uncompressed per-frame float
depth + RGBX color, and an optional ground-truth trajectory. The mLib
stream implementation is a git submodule absent from the reference
snapshot, so this module defines an equivalent, explicitly documented
layout (little-endian, magic-tagged) with the same field inventory:

  magic 'BFDUMP01' | dw dh cw chn (u32) | K_depth Kinv E_depth (3x 4x4 f32)
  | K_color Kinv E_color | num_frames (u64) | has_color has_traj (u8)
  | depth frames [N, dh, dw] f32 | color frames [N, ch, cw, 4] u8 (RGBX)
  | trajectory [N, 4, 4] f32 (if has_traj)

Use :func:`write_binary_dump` to produce dumps (e.g. from a .sens or a
live recording) and :func:`load_binary_dump` to read them.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics

MAGIC = b"BFDUMP01"


@dataclass
class BinaryDump:
    intrinsic_depth: np.ndarray    # [4, 4]
    extrinsic_depth: np.ndarray
    intrinsic_color: np.ndarray
    extrinsic_color: np.ndarray
    depth: np.ndarray              # [N, dh, dw] float32 meters (nan invalid)
    color: Optional[np.ndarray]    # [N, ch, cw, 4] uint8 RGBX or None
    trajectory: Optional[np.ndarray]  # [N, 4, 4] float32 or None

    def depth_intrinsics(self) -> CameraIntrinsics:
        K = self.intrinsic_depth
        return CameraIntrinsics(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
            cy=float(K[1, 2]), width=self.depth.shape[2], height=self.depth.shape[1],
        )

    def frame(self, i: int):
        """(depth [m], color float RGB [0,1] or None, pose or None)."""
        c = (
            self.color[i, ..., :3].astype(np.float32) / 255.0
            if self.color is not None
            else None
        )
        T = self.trajectory[i] if self.trajectory is not None else None
        return self.depth[i], c, T

    def __len__(self) -> int:
        return self.depth.shape[0]


def write_binary_dump(path: str, dump: BinaryDump):
    N, dh, dw = dump.depth.shape
    if dump.color is not None:
        _, ch, cw, four = dump.color.shape
        assert four == 4, "color must be RGBX uint8"
    else:
        ch = cw = 0
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<IIII", dw, dh, cw, ch))
        for m in (dump.intrinsic_depth, np.linalg.inv(dump.intrinsic_depth),
                  dump.extrinsic_depth, dump.intrinsic_color,
                  np.linalg.inv(dump.intrinsic_color), dump.extrinsic_color):
            fh.write(np.asarray(m, np.float32).tobytes())
        fh.write(struct.pack("<Q", N))
        fh.write(struct.pack("<BB", int(dump.color is not None),
                             int(dump.trajectory is not None)))
        d = np.where(np.isfinite(dump.depth), dump.depth, 0.0).astype("<f4")
        fh.write(d.tobytes())
        if dump.color is not None:
            fh.write(dump.color.astype(np.uint8).tobytes())
        if dump.trajectory is not None:
            fh.write(np.asarray(dump.trajectory, "<f4").tobytes())


def load_binary_dump(path: str, max_frames: Optional[int] = None) -> BinaryDump:
    with open(path, "rb") as fh:
        magic = fh.read(8)
        if magic != MAGIC:
            raise ValueError(f"not a binary dump (magic {magic!r})")
        dw, dh, cw, ch = struct.unpack("<IIII", fh.read(16))
        mats = [
            np.frombuffer(fh.read(64), "<f4").reshape(4, 4).copy()
            for _ in range(6)
        ]
        (N,) = struct.unpack("<Q", fh.read(8))
        has_color, has_traj = struct.unpack("<BB", fh.read(2))
        n = N if max_frames is None else min(N, max_frames)
        depth = np.frombuffer(fh.read(4 * N * dh * dw), "<f4").reshape(N, dh, dw)[:n]
        depth = np.where(depth > 0, depth, np.nan).astype(np.float32)
        color = None
        if has_color:
            color = np.frombuffer(
                fh.read(N * ch * cw * 4), np.uint8
            ).reshape(N, ch, cw, 4)[:n].copy()
        traj = None
        if has_traj:
            traj = np.frombuffer(fh.read(64 * N), "<f4").reshape(N, 4, 4)[:n].copy()
        return BinaryDump(
            intrinsic_depth=mats[0], extrinsic_depth=mats[2],
            intrinsic_color=mats[3], extrinsic_color=mats[5],
            depth=depth.copy(), color=color, trajectory=traj,
        )
