""".sens (mLib SensorData) sequence reader/writer.

The reference's primary offline input path is ``SensorDataReader``
(``SensorDataReader.cpp:38-124``) reading the mLib/ScanNet ``.sens`` binary:
header (version, sensor name, color+depth calibration, compression types,
resolutions, depth shift, frame count), then per-frame records of
{camera-to-world 4x4, timestamps, compressed color (JPEG) + depth
(zlib uint16)}. The optimized trajectory is written back into the same file
at scan end (``saveToFile``, SensorDataReader.cpp:153-166). This module
implements that format standalone (numpy + zlib + cv2 for JPEG).

Port of ``bundlefusion_tpu/io/sens.py``: ``cv2`` is imported only where JPEG or
PNG colour is decoded or encoded, so raw colour and zlib depth need nothing
but numpy and zlib.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics

COMPRESSION_COLOR = {0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_DEPTH = {0: "raw", 1: "zlib_ushort", 2: "occi_ushort"}


@dataclass
class SensFrame:
    camera_to_world: np.ndarray       # [4, 4] float32 (identity/-inf if none)
    timestamp_color: int
    timestamp_depth: int
    color_bytes: bytes
    depth_bytes: bytes


@dataclass
class SensData:
    version: int
    sensor_name: str
    intrinsic_color: np.ndarray       # [4, 4]
    extrinsic_color: np.ndarray
    intrinsic_depth: np.ndarray
    extrinsic_depth: np.ndarray
    compression_color: int
    compression_depth: int
    color_width: int
    color_height: int
    depth_width: int
    depth_height: int
    depth_shift: float                # depth [m] = stored / depth_shift
    frames: List[SensFrame] = field(default_factory=list)

    def color_intrinsics(self) -> CameraIntrinsics:
        K = self.intrinsic_color
        return CameraIntrinsics(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
            cy=float(K[1, 2]), width=self.color_width, height=self.color_height,
        )

    def depth_intrinsics(self) -> CameraIntrinsics:
        K = self.intrinsic_depth
        return CameraIntrinsics(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
            cy=float(K[1, 2]), width=self.depth_width, height=self.depth_height,
        )

    def decode_depth(self, i: int) -> np.ndarray:
        """Frame i depth as float32 meters [H, W]; 0/invalid -> nan."""
        if self.compression_depth == 0:
            raw = np.frombuffer(self.frames[i].depth_bytes, np.uint16)
            d = raw.reshape(self.depth_height, self.depth_width).astype(np.float32)
            d = d / self.depth_shift
            return np.where(d > 0, d, np.nan).astype(np.float32)
        return self.decode_depth_batch([i])[0]

    def decode_depth_batch(self, indices) -> np.ndarray:
        """Batch depth decode [len(indices), H, W] through the native
        multithreaded codec (native/sens_codec.cpp — the analog of the
        reference's ``RGBDFrameCacheRead`` prefetch threads,
        SensorDataReader.cpp:38-124); falls back to Python zlib."""
        from bundlefusion_tpu_torch.io.native import decode_depth_batch

        if self.compression_depth == 0:
            return np.stack([self.decode_depth(i) for i in indices])
        return decode_depth_batch(
            [self.frames[i].depth_bytes for i in indices],
            self.depth_height,
            self.depth_width,
            self.depth_shift,
        )

    def decode_color(self, i: int) -> np.ndarray:
        """Frame i color as float32 RGB [H, W, 3] in [0, 1]."""
        fr = self.frames[i]
        if self.compression_color == 0:
            img = np.frombuffer(fr.color_bytes, np.uint8).reshape(
                self.color_height, self.color_width, -1
            )[..., :3]
        else:
            import cv2

            img = cv2.imdecode(
                np.frombuffer(fr.color_bytes, np.uint8), cv2.IMREAD_COLOR
            )
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img.astype(np.float32) / 255.0

    def gt_trajectory(self) -> np.ndarray:
        """[N, 4, 4] camera-to-world; frames without a pose are -inf in the
        file (reference convention) -> returned as nan."""
        out = []
        for fr in self.frames:
            T = fr.camera_to_world.astype(np.float64)
            out.append(np.where(np.isfinite(T), T, np.nan))
        return np.stack(out).astype(np.float32)


def _read_mat4(fh) -> np.ndarray:
    return np.frombuffer(fh.read(64), np.float32).reshape(4, 4).copy()


def load_sens(path: str, max_frames: Optional[int] = None, load_payload: bool = True) -> SensData:
    with open(path, "rb") as fh:
        version = struct.unpack("<I", fh.read(4))[0]
        strlen = struct.unpack("<Q", fh.read(8))[0]
        name = fh.read(strlen).decode(errors="replace")
        intr_c = _read_mat4(fh)
        extr_c = _read_mat4(fh)
        intr_d = _read_mat4(fh)
        extr_d = _read_mat4(fh)
        comp_c, comp_d = struct.unpack("<ii", fh.read(8))
        cw, ch, dw, dh = struct.unpack("<IIII", fh.read(16))
        depth_shift = struct.unpack("<f", fh.read(4))[0]
        num_frames = struct.unpack("<Q", fh.read(8))[0]
        data = SensData(
            version=version, sensor_name=name,
            intrinsic_color=intr_c, extrinsic_color=extr_c,
            intrinsic_depth=intr_d, extrinsic_depth=extr_d,
            compression_color=comp_c, compression_depth=comp_d,
            color_width=cw, color_height=ch, depth_width=dw, depth_height=dh,
            depth_shift=depth_shift,
        )
        n = num_frames if max_frames is None else min(num_frames, max_frames)
        for _ in range(n):
            T = _read_mat4(fh)
            ts_c, ts_d = struct.unpack("<QQ", fh.read(16))
            len_c, len_d = struct.unpack("<QQ", fh.read(16))
            cb = fh.read(len_c) if load_payload else fh.seek(len_c, 1) or b""
            db = fh.read(len_d) if load_payload else fh.seek(len_d, 1) or b""
            data.frames.append(SensFrame(T, ts_c, ts_d, cb, db))
        return data


def save_sens(path: str, data: SensData):
    with open(path, "wb") as fh:
        fh.write(struct.pack("<I", data.version))
        name = data.sensor_name.encode()
        fh.write(struct.pack("<Q", len(name)))
        fh.write(name)
        for m in (data.intrinsic_color, data.extrinsic_color, data.intrinsic_depth, data.extrinsic_depth):
            fh.write(np.asarray(m, np.float32).tobytes())
        fh.write(struct.pack("<ii", data.compression_color, data.compression_depth))
        fh.write(struct.pack("<IIII", data.color_width, data.color_height, data.depth_width, data.depth_height))
        fh.write(struct.pack("<f", data.depth_shift))
        fh.write(struct.pack("<Q", len(data.frames)))
        for fr in data.frames:
            fh.write(np.asarray(fr.camera_to_world, np.float32).tobytes())
            fh.write(struct.pack("<QQ", fr.timestamp_color, fr.timestamp_depth))
            fh.write(struct.pack("<QQ", len(fr.color_bytes), len(fr.depth_bytes)))
            fh.write(fr.color_bytes)
            fh.write(fr.depth_bytes)


def write_trajectory(path: str, data: SensData, trajectory: np.ndarray):
    """Overwrite per-frame poses with an optimized trajectory and save
    (reference ``SensorDataReader::saveToFile`` behavior: invalid frames
    stored as -inf)."""
    for i, fr in enumerate(data.frames):
        if i < len(trajectory) and np.isfinite(trajectory[i]).all():
            fr.camera_to_world = trajectory[i].astype(np.float32)
        else:
            fr.camera_to_world = np.full((4, 4), -np.inf, np.float32)
    save_sens(path, data)


def encode_frames(depths: np.ndarray, colors: np.ndarray, poses: np.ndarray, intr: CameraIntrinsics, depth_shift: float = 1000.0, jpeg_quality: int = 90) -> SensData:
    """Pack numpy depth [N, H, W] (meters) + color [N, H, W, 3] (0..1) +
    poses into a SensData (zlib depth, JPEG color) — used for recording
    (reference ``RGBDSensor::saveRecordedFramesToFile``) and tests."""
    import cv2

    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = intr.fx, intr.fy, intr.cx, intr.cy
    N, H, W = depths.shape
    data = SensData(
        version=4, sensor_name="bundlefusion_tpu",
        intrinsic_color=K, extrinsic_color=np.eye(4, dtype=np.float32),
        intrinsic_depth=K, extrinsic_depth=np.eye(4, dtype=np.float32),
        compression_color=2, compression_depth=1,
        color_width=W, color_height=H, depth_width=W, depth_height=H,
        depth_shift=depth_shift,
    )
    for i in range(N):
        d = depths[i]
        du = np.where(np.isfinite(d), np.clip(d * depth_shift, 0, 65535), 0).astype(np.uint16)
        db = zlib.compress(du.tobytes())
        bgr = cv2.cvtColor((np.clip(colors[i], 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
        ok, enc = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
        assert ok
        data.frames.append(
            SensFrame(poses[i].astype(np.float32), i, i, enc.tobytes(), db)
        )
    return data
