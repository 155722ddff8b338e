"""Engine checkpoints of the port (``io/checkpoint.py``, ``BundleFusion.save``
/ ``load``) on the patterns of ``tests/test_checkpoint.py``.

- The port saved at frame 7 of 13, loaded and continued, ends where its
  unbroken run ends, bit for bit: flags, trajectory and the table's index
  and payload. Both runs retire the same submaps at the same frames (the
  port reads a boundary's pack at the end of its own frame, and ``save``
  only records the open window's frames early, which changes no
  computation).
- Host-paged blocks survive a save and a load (``hb_*``), and stream back
  into the same volume.
- A checkpoint written by the JAX package's ``save_engine`` at frame 7 loads
  into the port, and the port continued for 6 frames and ``finish`` gives
  the JAX engine's flags and a trajectory within the tolerance of
  ``tests/test_torch_engine.py`` (5 mm, 5 mrad): both are float32 pipelines
  whose sums run in another order.
"""

import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import AppConfig as JaxApp
from bundlefusion_tpu.config import BundlingConfig as JaxBundling
from bundlefusion_tpu.io.checkpoint import save_engine as jax_save_engine
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.sift import SiftConfig as JaxSift
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.io.checkpoint import load_engine, save_engine
from bundlefusion_tpu_torch.pipeline.online import BundleFusion
from bundlefusion_tpu_torch.tsdf.table import EMPTY_KEY, check_invariants
from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse
from tests.torch_parity import APP, BUNDLING, SIFT

N = 13
SAVE_AT = 7
TRANS_TOL = 5e-3   # metres
ROT_TOL = 5e-3     # radians
BUND = dict(BUNDLING, submap_size=4)


def _engine(**app):
    intr = default_intrinsics(160, 120)
    return BundleFusion(CameraIntrinsics(**intr.__dict__), port.AppConfig(**dict(APP, **app)),
                        port.BundlingConfig(**BUND), sift_cfg=port.SiftConfig(**SIFT),
                        max_keyframes=8, device="cpu")


@pytest.fixture(scope="module")
def seq():
    return make_sequence(N, intr=default_intrinsics(160, 120))


def _table_state(eng):
    t = eng.table
    return {name: getattr(t, name).clone() for name in
            ("keys", "slots", "sdf", "weight", "color", "free_list", "free_count",
             "slot_keys", "slot_geo", "high_water")}


def test_save_load_continue_bit_for_bit(seq, tmp_path):
    straight = _engine()
    for i in range(N):
        straight.process_frame(seq["depth"][i], seq["color"][i])
    straight.finish(extra_solves=1)

    first = _engine()
    for i in range(SAVE_AT):
        first.process_frame(seq["depth"][i], seq["color"][i])
    path = str(tmp_path / "engine.npz")
    first.save(path)
    del first
    resumed = BundleFusion.load(path, device="cpu")
    assert resumed.frame_idx == SAVE_AT and resumed.device == torch.device("cpu")
    for i in range(SAVE_AT, N):
        resumed.process_frame(seq["depth"][i], seq["color"][i])
    resumed.finish(extra_solves=1)

    assert resumed.frame_valid == straight.frame_valid
    np.testing.assert_array_equal(resumed.keyframe_valid, straight.keyframe_valid)
    np.testing.assert_array_equal(resumed.trajectory(), straight.trajectory())
    np.testing.assert_array_equal(np.stack(resumed.sift_world), np.stack(straight.sift_world))
    a, b = _table_state(straight), _table_state(resumed)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert all(v == 0 for v in check_invariants(resumed.table).values())
    rmse, n = evaluate_ate_rmse(resumed.trajectory(), seq["poses"][:N])
    assert n == N and rmse < 0.06


def test_checkpoint_keeps_host_paged_blocks(seq, tmp_path):
    eng = _engine(streaming_enabled=True, streaming_radius=6.0, streaming_every=4,
                  streaming_blocked_cap=8192, top_n_active=0)
    for i in range(9):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    eng._flush_pending()
    far = np.eye(4, dtype=np.float32)
    far[:3, 3] = [50.0, 0, 0]
    eng.sift_world.append(far)
    eng._stream_update()
    assert len(eng.host_blocks) > 0
    path = str(tmp_path / "paged.npz")
    save_engine(eng, path)
    back = load_engine(path, device="cpu")
    assert list(back.host_blocks.blocks) == list(eng.host_blocks.blocks)
    assert torch.equal(back._blocked_dev, eng._blocked_dev)
    for e in (eng, back):
        e.sift_world[-1] = seq["poses"][0]
        e._stream_update()
        assert len(e.host_blocks) == 0
    for name, a in _table_state(eng).items():
        assert torch.equal(a, getattr(back.table, name)), name
    # a paged checkpoint needs a paging engine to load into
    with pytest.raises(ValueError, match="streaming is off"):
        import json

        data = dict(np.load(path))
        meta = json.loads(bytes(data["meta_json"]).decode())
        meta["app"]["streaming_enabled"] = False
        data["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        np.savez(str(tmp_path / "off.npz"), **data)
        load_engine(str(tmp_path / "off.npz"), device="cpu")


def _pose_diff(A, B):
    dt = np.linalg.norm(A[:3, 3] - B[:3, 3])
    dR = A[:3, :3].T @ B[:3, :3]
    return dt, np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))


def test_port_resumes_a_jax_checkpoint(seq, tmp_path):
    intr = default_intrinsics(160, 120)
    jeng = JaxEngine(intr, JaxApp(**APP), JaxBundling(**BUND), sift_cfg=JaxSift(**SIFT),
                     max_keyframes=8)
    for i in range(SAVE_AT):
        jeng.process_frame(seq["depth"][i], seq["color"][i])
    path = str(tmp_path / "jax.npz")
    jax_save_engine(jeng, path)

    teng = load_engine(path, device="cpu")
    assert teng.frame_idx == SAVE_AT and teng.num_keyframes == jeng.num_keyframes
    assert teng.frame_valid == jeng.frame_valid
    np.testing.assert_array_equal(teng.table.keys.numpy(), np.asarray(jeng.table.keys))
    np.testing.assert_array_equal(teng.table.slot_geo.numpy(),
                                  np.asarray(jeng.table.slot_geo)[:, :4])
    np.testing.assert_array_equal(teng.store.depth_mm.to(torch.int32).numpy(),
                                  np.asarray(jeng.store.depth_mm))
    assert torch.equal(teng.glob.keys.desc.float(),
                       torch.from_numpy(np.array(jeng.glob.keys.desc.astype(np.float32))))
    assert all(v == 0 for v in check_invariants(teng.table).values())

    for i in range(SAVE_AT, N):
        jeng.process_frame(seq["depth"][i], seq["color"][i])
        teng.process_frame(seq["depth"][i], seq["color"][i])
    jeng.finish(extra_solves=1)
    teng.finish(extra_solves=1)
    assert teng.frame_valid == jeng.frame_valid == [True] * N
    np.testing.assert_array_equal(teng.keyframe_valid, jeng.keyframe_valid)
    A, B = teng.trajectory(), jeng.trajectory()
    assert A.shape == B.shape == (N, 4, 4)
    for f in range(N):
        dt, ang = _pose_diff(A[f], np.asarray(B[f]))
        assert dt < TRANS_TOL and ang < ROT_TOL, (f, dt, ang)
    live = int((teng.table.keys != EMPTY_KEY).sum())
    assert abs(live - int((np.asarray(jeng.table.keys) != int(EMPTY_KEY)).sum())) <= 0.02 * live
