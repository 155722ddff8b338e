"""The port's recorded-input readers and writers against the JAX package's.

``.sens`` files (``tests/fixtures/tiny.sens``: 12 frames at 160x120, JPEG
colour, zlib depth, true poses) load to the same header, depth, colour and
poses bit for bit through both packages, and ``save_sens`` /
``write_trajectory`` / ``encode_frames`` write the same bytes; the TUM,
binary-dump and sensor layers give the same frames on the patterns of
``tests/test_io.py`` and ``tests/test_sensors_io.py``; the native depth
codec equals the Python zlib path bit for bit, and a corrupt buffer raises
``zlib.error`` through both packages (``tests/test_native.py``).
"""

import os
import zlib

import numpy as np
import pytest

from bundlefusion_tpu.geometry.camera import CameraIntrinsics as JaxIntrinsics
from bundlefusion_tpu.io import binary_dump as jdump
from bundlefusion_tpu.io import native as jnative
from bundlefusion_tpu.io import sens as jsens
from bundlefusion_tpu.io import sensors as jsensors
from bundlefusion_tpu.io import tum as jtum
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.io import binary_dump as tdump
from bundlefusion_tpu_torch.io import native as tnative
from bundlefusion_tpu_torch.io import sens as tsens
from bundlefusion_tpu_torch.io import sensors as tsensors
from bundlefusion_tpu_torch.io import tum as ttum

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny.sens")


def _bits_equal(a, b):
    """Float arrays equal bit for bit (NaN included)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32), np.asarray(b).view(np.uint32))


def test_fixture_loads_the_same_through_both_packages():
    j, t = jsens.load_sens(FIXTURE), tsens.load_sens(FIXTURE)
    for name in ("version", "sensor_name", "compression_color", "compression_depth",
                 "color_width", "color_height", "depth_width", "depth_height",
                 "depth_shift"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.depth_intrinsics().__dict__ == j.depth_intrinsics().__dict__
    assert t.color_intrinsics().__dict__ == j.color_intrinsics().__dict__
    assert len(t.frames) == len(j.frames) == 12
    _bits_equal(t.decode_depth_batch(range(12)), j.decode_depth_batch(range(12)))
    _bits_equal(t.decode_depth(5), j.decode_depth(5))
    for i in (0, 11):
        _bits_equal(t.decode_color(i), j.decode_color(i))
    _bits_equal(t.gt_trajectory(), j.gt_trajectory())
    assert np.isfinite(t.gt_trajectory()).all()


def test_max_frames_and_no_payload():
    t = tsens.load_sens(FIXTURE, max_frames=5)
    j = jsens.load_sens(FIXTURE, max_frames=5)
    assert len(t.frames) == len(j.frames) == 5
    head = tsens.load_sens(FIXTURE, load_payload=False)
    assert len(head.frames) == 12
    _bits_equal(head.gt_trajectory(), jsens.load_sens(FIXTURE).gt_trajectory())


def test_save_and_write_trajectory_bytes_equal(tmp_path):
    t, j = tsens.load_sens(FIXTURE), jsens.load_sens(FIXTURE)
    tsens.save_sens(str(tmp_path / "t.sens"), t)
    jsens.save_sens(str(tmp_path / "j.sens"), j)
    assert (tmp_path / "t.sens").read_bytes() == (tmp_path / "j.sens").read_bytes()
    assert (tmp_path / "t.sens").read_bytes() == open(FIXTURE, "rb").read()
    traj = t.gt_trajectory().copy()
    traj[:, 1, 3] += 0.25
    traj[4] = np.nan            # an invalid frame is stored as -inf
    tsens.write_trajectory(str(tmp_path / "t2.sens"), t, traj[:10])
    jsens.write_trajectory(str(tmp_path / "j2.sens"), j, traj[:10])
    assert (tmp_path / "t2.sens").read_bytes() == (tmp_path / "j2.sens").read_bytes()
    back = tsens.load_sens(str(tmp_path / "t2.sens")).gt_trajectory()
    np.testing.assert_allclose(back[:4], traj[:4], atol=1e-6)
    assert np.isnan(back[4]).all() and np.isnan(back[10:]).all()


def test_raw_colour_zlib_depth_round_trip(tmp_path):
    """The encoding the card's machine can decode without cv2: raw colour,
    zlib depth; the port writes it and both packages read it."""
    rng = np.random.default_rng(0)
    n, h, w = 3, 24, 32
    d_mm = rng.integers(0, 4000, (n, h, w)).astype(np.uint16)
    col = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 30.0
    data = tsens.SensData(
        version=4, sensor_name="raw", intrinsic_color=K, extrinsic_color=np.eye(4, dtype=np.float32),
        intrinsic_depth=K, extrinsic_depth=np.eye(4, dtype=np.float32),
        compression_color=0, compression_depth=1, color_width=w, color_height=h,
        depth_width=w, depth_height=h, depth_shift=1000.0,
        frames=[tsens.SensFrame(np.eye(4, dtype=np.float32), i, i, col[i].tobytes(),
                                zlib.compress(d_mm[i].tobytes())) for i in range(n)])
    p = str(tmp_path / "raw.sens")
    tsens.save_sens(p, data)
    t, j = tsens.load_sens(p), jsens.load_sens(p)
    _bits_equal(t.decode_depth_batch(range(n)), j.decode_depth_batch(range(n)))
    for i in range(n):
        _bits_equal(t.decode_color(i), j.decode_color(i))
        np.testing.assert_array_equal(np.round(t.decode_color(i) * 255).astype(np.uint8), col[i])
    d = t.decode_depth_batch(range(n))
    np.testing.assert_array_equal(np.isnan(d), d_mm == 0)
    np.testing.assert_allclose(d[d_mm > 0], d_mm[d_mm > 0] / 1000.0, rtol=1e-6)


def test_encode_frames_bytes_equal(rng):
    n, h, w = 3, 24, 32
    depth = rng.uniform(0.5, 3.0, (n, h, w)).astype(np.float32)
    depth[0, 0, 0] = np.nan
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    color = np.stack([np.stack([xx, yy, 0.5 * (xx + yy)], -1) * (0.8 + 0.1 * i)
                      for i in range(n)]).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    kw = dict(fx=30.0, fy=30.0, cx=15.5, cy=11.5, width=w, height=h)
    t = tsens.encode_frames(depth, color, poses, CameraIntrinsics(**kw))
    j = jsens.encode_frames(depth, color, poses, JaxIntrinsics(**kw))
    for a, b in zip(t.frames, j.frames):
        assert a.depth_bytes == b.depth_bytes and a.color_bytes == b.color_bytes


@pytest.mark.parametrize("n_threads", [1, 3])
def test_native_decode_equals_python_zlib(rng, n_threads):
    assert tnative.native_available()
    shift = 1000.0
    raw = rng.integers(0, 65536, (8, 24, 32)).astype(np.uint16)
    raw[:, 0, 0] = 0
    bufs = [zlib.compress(r.tobytes()) for r in raw]
    native = tnative.decode_depth_batch(bufs, 24, 32, shift, num_threads=n_threads)
    _bits_equal(native, tnative.decode_depth_batch_python(bufs, 24, 32, shift))
    _bits_equal(native, jnative.decode_depth_batch(bufs, 24, 32, shift, num_threads=n_threads))
    assert np.isnan(native[:, 0, 0]).all()
    # every uint16 value converts to the same bits on both paths
    every = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    buf = [zlib.compress(every.tobytes())]
    _bits_equal(tnative.decode_depth_batch(buf, 256, 256, shift),
                tnative.decode_depth_batch_python(buf, 256, 256, shift))


def test_corrupt_buffer_raises_through_both(rng):
    bufs = [zlib.compress(np.ones((24, 32), np.uint16).tobytes()), b"not a zlib stream"]
    with pytest.raises(zlib.error):
        tnative.decode_depth_batch(bufs, 24, 32, 1000.0)
    with pytest.raises(zlib.error):
        jnative.decode_depth_batch(bufs, 24, 32, 1000.0)


def test_tum_reader_matches(tmp_path, rng):
    import cv2

    root = tmp_path / "rgbd_dataset_freiburg2_test"
    (root / "depth").mkdir(parents=True)
    (root / "rgb").mkdir()
    dlines, rlines, glines = [], [], []
    for i in range(3):
        ts = 100.0 + i * 0.033
        cv2.imwrite(str(root / "depth" / f"{ts:.6f}.png"),
                    (rng.uniform(0.5, 3.0, (24, 32)) * 5000).astype(np.uint16))
        cv2.imwrite(str(root / "rgb" / f"{ts:.6f}.png"),
                    (rng.uniform(0, 1, (24, 32, 3)) * 255).astype(np.uint8))
        dlines.append(f"{ts:.6f} depth/{ts:.6f}.png")
        rlines.append(f"{ts + 0.004:.6f} rgb/{ts:.6f}.png")
        glines.append(f"{ts:.6f} {0.1 * i:.3f} 0.2 0 0.1 0 0 0.995")
    (root / "depth.txt").write_text("# header\n" + "\n".join(dlines))
    (root / "rgb.txt").write_text("\n".join(rlines))
    (root / "groundtruth.txt").write_text("\n".join(glines))
    t, j = ttum.load_tum(str(root)), jtum.load_tum(str(root))
    assert t.intrinsics.__dict__ == j.intrinsics.__dict__ == ttum.FR2_INTRINSICS.__dict__
    assert len(t) == len(j) == 3
    for i in range(3):
        (td, tc, tp), (jd, jc, jp) = t.frame(i), j.frame(i)
        _bits_equal(td, jd)
        _bits_equal(tc, jc)
        np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(t.frame(1)[2][0, 3], 0.1, atol=1e-6)


def _k44(fx=100.0, cx=40.0, cy=30.0):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fx, cx, cy
    return K


def test_binary_dump_round_trip_matches(tmp_path):
    rng = np.random.default_rng(0)
    n = 3
    depth = rng.uniform(0.5, 3.0, (n, 60, 80)).astype(np.float32)
    depth[0, 0, 0] = np.nan
    fields = dict(intrinsic_depth=_k44(), extrinsic_depth=np.eye(4, dtype=np.float32),
                  intrinsic_color=_k44(), extrinsic_color=np.eye(4, dtype=np.float32),
                  depth=depth, color=rng.integers(0, 255, (n, 60, 80, 4)).astype(np.uint8),
                  trajectory=np.stack([np.eye(4, dtype=np.float32)] * n))
    tdump.write_binary_dump(str(tmp_path / "t.dump"), tdump.BinaryDump(**fields))
    jdump.write_binary_dump(str(tmp_path / "j.dump"), jdump.BinaryDump(**fields))
    assert (tmp_path / "t.dump").read_bytes() == (tmp_path / "j.dump").read_bytes()
    t = tdump.load_binary_dump(str(tmp_path / "t.dump"), max_frames=2)
    j = jdump.load_binary_dump(str(tmp_path / "t.dump"), max_frames=2)
    assert len(t) == len(j) == 2
    _bits_equal(t.depth, j.depth)
    np.testing.assert_array_equal(t.color, j.color)
    assert t.depth_intrinsics().__dict__ == j.depth_intrinsics().__dict__
    s = tsensors.get_rgbd_sensor(3, str(tmp_path / "t.dump")).create_first_connected()
    d, c, T = next(iter(s.frames()))
    assert d.shape == (60, 80) and c.shape == (60, 80, 3) and T is not None
    with pytest.raises(ValueError, match="not a binary dump"):
        tdump.load_binary_dump(FIXTURE)


def test_sensor_layer_matches(tmp_path):
    t = tsensors.get_rgbd_sensor(8, FIXTURE, max_frames=6).create_first_connected()
    j = jsensors.get_rgbd_sensor(8, FIXTURE, max_frames=6).create_first_connected()
    assert len(t) == len(j) == 6
    assert t.intrinsics().__dict__ == j.intrinsics().__dict__
    for (td, tc, tp), (jd, jc, jp) in zip(t.frames(), j.frames()):
        _bits_equal(td, jd)
        _bits_equal(tc, jc)
        np.testing.assert_array_equal(tp, jp)
    with pytest.raises(RuntimeError, match="Kinect"):
        tsensors.KinectSensor().create_first_connected()
    with pytest.raises(ValueError):
        tsensors.get_rgbd_sensor(99)
    with pytest.raises(ValueError, match="needs an input path"):
        tsensors.get_rgbd_sensor(8)
    # recording: the port's and the reference's recordings hold the same bytes
    t.record_to_sens(str(tmp_path / "t.sens"), max_frames=4)
    j.record_to_sens(str(tmp_path / "j.sens"), max_frames=4)
    assert (tmp_path / "t.sens").read_bytes() == (tmp_path / "j.sens").read_bytes()
    assert len(tsensors.get_rgbd_sensor(8, str(tmp_path / "t.sens"))
               .create_first_connected()) == 4
