"""Sensor adapter layer (RGBDSensor hierarchy analog).

Port of ``bundlefusion_tpu/io/sensors.py`` (numpy only).

The reference abstracts input behind ``RGBDSensor`` (RGBDSensor.h:25-82)
with live adapters (KinectSensor, KinectOneSensor, PrimeSenseSensor,
StructureSensor) and offline readers (SensorDataReader for .sens,
BinaryDumpReader), selected by ``s_sensorIdx`` (FriedLiver.cpp:7-103).
This module provides the same factory contract: offline readers are fully
functional; live-sensor adapters are explicit stubs (their SDKs are
Windows-only and out of scope — the classes exist so sensor_idx mapping,
error messages, and the recording path have the reference shape).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics


class RGBDSensor:
    """Abstract sensor: yields (depth [H, W] float32 m, color [H, W, 3]
    float32 0..1, optional GT pose) frames, exposes intrinsics."""

    name = "abstract"

    def create_first_connected(self):
        raise NotImplementedError

    def intrinsics(self) -> CameraIntrinsics:
        raise NotImplementedError

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def record_to_sens(self, path: str, max_frames: Optional[int] = None):
        """Record the stream to a .sens file
        (``RGBDSensor::saveRecordedFramesToFile`` analog)."""
        from bundlefusion_tpu_torch.io.sens import encode_frames, save_sens

        depths, colors, poses = [], [], []
        for i, (d, c, T) in enumerate(self.frames()):
            if max_frames is not None and i >= max_frames:
                break
            depths.append(d)
            colors.append(c)
            poses.append(T if T is not None else np.eye(4, dtype=np.float32))
        data = encode_frames(
            np.stack(depths), np.stack(colors), np.stack(poses), self.intrinsics()
        )
        save_sens(path, data)


class _LiveSensorStub(RGBDSensor):
    """Live sensors need platform SDKs absent from this environment."""

    sdk = "?"

    def create_first_connected(self):
        raise RuntimeError(
            f"{self.name}: live capture requires the {self.sdk} SDK, which is "
            f"not available in this build. Record the stream to .sens on a "
            f"capture machine and use sensor_idx=8 (SensorDataReader)."
        )


class KinectSensor(_LiveSensorStub):
    name, sdk = "KinectSensor", "Kinect for Windows v1"


class KinectOneSensor(_LiveSensorStub):
    name, sdk = "KinectOneSensor", "Kinect v2"


class PrimeSenseSensor(_LiveSensorStub):
    name, sdk = "PrimeSenseSensor", "OpenNI2"


class StructureSensor(_LiveSensorStub):
    name, sdk = "StructureSensor", "Uplink network streaming"


class SensFileSensor(RGBDSensor):
    """Offline .sens reader (SensorDataReader, s_sensorIdx=8)."""

    name = "SensorDataReader"

    def __init__(self, path: str, max_frames: Optional[int] = None):
        self.path = path
        self.max_frames = max_frames
        self.data = None

    def create_first_connected(self):
        from bundlefusion_tpu_torch.io.sens import load_sens

        self.data = load_sens(self.path, max_frames=self.max_frames)
        return self

    def intrinsics(self) -> CameraIntrinsics:
        return self.data.depth_intrinsics()

    def __len__(self):
        return len(self.data.frames)

    def frames(self):
        gt = self.data.gt_trajectory()
        n = len(self.data.frames)
        B = 16
        for s in range(0, n, B):
            e = min(n, s + B)
            depths = self.data.decode_depth_batch(range(s, e))
            for k in range(s, e):
                T = gt[k] if np.isfinite(gt[k]).all() else None
                yield depths[k - s], self.data.decode_color(k), T


class BinaryDumpSensor(RGBDSensor):
    """Offline binary-dump reader (BinaryDumpReader, s_sensorIdx=3)."""

    name = "BinaryDumpReader"

    def __init__(self, path: str, max_frames: Optional[int] = None):
        self.path = path
        self.max_frames = max_frames
        self.data = None

    def create_first_connected(self):
        from bundlefusion_tpu_torch.io.binary_dump import load_binary_dump

        self.data = load_binary_dump(self.path, max_frames=self.max_frames)
        return self

    def intrinsics(self) -> CameraIntrinsics:
        return self.data.depth_intrinsics()

    def __len__(self):
        return len(self.data)

    def frames(self):
        for i in range(len(self.data)):
            d, c, T = self.data.frame(i)
            if c is None:
                c = np.zeros(d.shape + (3,), np.float32)
            yield d, c, T


# reference sensor_idx mapping (FriedLiver.cpp getRGBDSensor)
SENSOR_FACTORY = {
    0: KinectSensor,
    1: PrimeSenseSensor,
    2: KinectOneSensor,
    3: BinaryDumpSensor,
    7: StructureSensor,
    8: SensFileSensor,
}


def get_rgbd_sensor(sensor_idx: int, path: Optional[str] = None,
                    max_frames: Optional[int] = None) -> RGBDSensor:
    """Sensor factory by index (``getRGBDSensor``, FriedLiver.cpp:7-103)."""
    if sensor_idx not in SENSOR_FACTORY:
        raise ValueError(f"unknown sensor_idx {sensor_idx}")
    cls = SENSOR_FACTORY[sensor_idx]
    if issubclass(cls, (SensFileSensor, BinaryDumpSensor)):
        if path is None:
            raise ValueError(f"sensor_idx {sensor_idx} needs an input path")
        return cls(path, max_frames=max_frames)
    return cls()
