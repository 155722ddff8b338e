"""The drift demo of the port (``bundlefusion_tpu_torch.scripts.drift_demo``)
at its CPU size against the JAX engine on the same frames.

Both engines run the JAX script's CPU configuration: 41 frames of the
out-and-back ``loop_trajectory`` at 160x120 with 0.5 % depth noise and a
blackout of one submap (frames 26-29), the small capacities, 12 keyframes
and a 40x30 dense cache. The frames are rendered once, by the JAX renderer,
and fed to both: the port's ``drift_demo.main`` reads them through its
``make_sequence_wire``. Required: the same keyframes, lost keyframes, valid
/ invalid frames and frames valid again after the blackout; the script's
two checks hold on both; optimized ATE within ``TRANS_TOL`` of the JAX
run's; the port wrote only under its ``--out``.

At this cache size a correct loop closure leaves a dense-verify error near
the 0.075 threshold, so the counts follow small differences upstream. The
first place the two engines can part is keyframe 0: the SIFT keys of
frames 0-3 and the keys fused from their tracks. Those are held here too
(ROADMAP Queue 3 has what parted them before).
"""

import json
import os

import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, loop_trajectory, make_sequence_wire
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
from bundlefusion_tpu.utils.metrics import evaluate_ate_rmse
from bundlefusion_tpu_torch.io import synthetic as port_synthetic
from bundlefusion_tpu_torch.scripts import drift_demo
from tests.torch_parity import APP, BUNDLING, SIFT
from tests.torch_scripts_util import outside_writes, snapshot

N_FRAMES = 41
SUB = 4
TRANS_TOL = 5e-3   # metres, as tests/test_torch_engine.py
KEYS = ("keyframes", "lost_keyframes", "valid_frames", "invalid_frames",
        "recovered_frames_after_blackout")
KEY_FIELDS = ("valid", "pos", "depth", "desc")
POS_ATOL = 1e-3    # px, fused keys (averaged track positions)
DEPTH_ATOL = 1e-5  # m
DESC_COS = 0.99    # as tests/test_torch_sift.py
# share of keys whose descriptor may turn: as tests/test_torch_sift.py lets
# 2 % of keys' orientations move (a sample on a histogram bin's edge, or a
# flat histogram whose peak rounding picks)
DESC_OFF = 0.02


def _keys_np(store, slots):
    out = {}
    for f in KEY_FIELDS:
        x = getattr(store, f)[slots]
        out[f] = np.array(x.float()) if isinstance(x, torch.Tensor) and x.is_floating_point() \
            else np.array(x.astype(np.float32) if f == "desc" else x)
    return out


def _snap(eng, done, snaps):
    """After frame SUB - 1: the window's keys of frames 0..SUB-1; after
    frame SUB (the first boundary): keyframe 0's fused keys."""
    if done == SUB:
        snaps["frames"] = _keys_np(eng.local.keys, slice(0, SUB))
    elif done == SUB + 1:
        snaps["kf0"] = _keys_np(eng.glob.keys, slice(0, 1))


def _jax_demo(seq, blackout):
    """The JAX engine on the demo's CPU configuration, as the demo drives it."""
    intr = default_intrinsics(160, 120)
    app = AppConfig(**{k: v for k, v in APP.items() if k != "alloc_max_new_blocks_per_frame"})
    bund = BundlingConfig(**dict(BUNDLING, submap_size=SUB))
    eng = JaxEngine(intr, app, bund, sift_cfg=SiftConfig(**SIFT), max_keyframes=12)
    snaps = {}
    for i in range(N_FRAMES):
        eng.process_frame(seq["depth"][i], seq["color"][i])
        _snap(eng, i + 1, snaps)
    eng.finish(extra_solves=3)
    opt = eng.trajectory()
    valid = np.isfinite(opt).all((1, 2))
    chained = np.stack(eng.sift_world)
    ate_c, _ = evaluate_ate_rmse(np.where(valid[:, None, None], chained, np.nan), seq["poses"])
    ate_o, _ = evaluate_ate_rmse(opt, seq["poses"])
    after = np.arange(N_FRAMES) >= blackout[1] + SUB
    out = {"keyframes": eng.num_keyframes, "lost_keyframes": eng.lost_count,
           "valid_frames": int(valid.sum()), "invalid_frames": int((~valid).sum()),
           "recovered_frames_after_blackout": [int((valid & after).sum()), int(after.sum())],
           "ate_chained_cm": ate_c * 100, "ate_optimized_cm": ate_o * 100,
           "blackout": list(blackout)}
    return out, snaps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    blackout = drift_demo.blackout_of(N_FRAMES, SUB)
    seq = make_sequence_wire(N_FRAMES, intr=default_intrinsics(160, 120),
                             poses=loop_trajectory(N_FRAMES), noise_depth=drift_demo.NOISE,
                             blackout=blackout)
    jax_run, jax_snaps = _jax_demo(seq, blackout)

    port_snaps = {}

    def same_frames(n, intr=None, poses=None, noise_depth=0.0, blackout=None, device="cpu"):
        assert (n, noise_depth, tuple(blackout)) == (N_FRAMES, drift_demo.NOISE, tuple(
            jax_run["blackout"])) and np.allclose(poses, seq["poses"], atol=1e-6)
        return {"depth": seq["depth"], "color": seq["color"], "poses": seq["poses"],
                "intrinsics": intr}

    def hook(eng):
        inner = eng.process_frame

        def process_frame(*args):
            out = inner(*args)
            _snap(eng, eng.frame_idx, port_snaps)
            return out

        eng.process_frame = process_frame

    out_dir = tmp_path_factory.mktemp("drift_demo")
    before = snapshot()
    mp = pytest.MonkeyPatch()
    mp.setattr(port_synthetic, "make_sequence_wire", same_frames)
    try:
        port = drift_demo.main(["--device", "cpu", "--out", str(out_dir)], hook=hook)
    except AssertionError:
        # the demo's own check failed after it wrote its result: the tests
        # below say which count or stage parted from the JAX engine's
        with open(out_dir / "drift_demo.json") as fh:
            port = json.load(fh)
    finally:
        mp.undo()
    return port, jax_run, outside_writes(before), out_dir, port_snaps, jax_snaps


def test_counts_equal_the_jax_engines(runs):
    port, jax_run = runs[:2]
    assert port["frames"] == N_FRAMES and port["blackout"] == jax_run["blackout"]
    assert {k: port[k] for k in KEYS} == {k: jax_run[k] for k in KEYS}


@pytest.mark.parametrize("side", ["port", "jax"])
def test_the_demos_checks_hold(runs, side):
    out = runs[0] if side == "port" else runs[1]
    drift_demo.check(out, SUB)
    assert out["lost_keyframes"] >= 1 or out["invalid_frames"] >= SUB


def test_optimized_ate_matches_and_beats_odometry(runs):
    port, jax_run = runs[:2]
    assert abs(port["ate_optimized_cm"] - jax_run["ate_optimized_cm"]) / 100 < TRANS_TOL
    assert port["ate_optimized_cm"] < port["ate_chained_cm"]
    assert jax_run["ate_optimized_cm"] < jax_run["ate_chained_cm"]


@pytest.mark.parametrize("stage", ["frames", "kf0"])
def test_keyframe_0_equals_the_jax_engines(runs, stage):
    """``frames``: the SIFT keys of frames 0-3 as the window holds them;
    ``kf0``: the keys fused from their tracks at the first boundary. The
    same keys at the same places and depths, and all but ``DESC_OFF`` of
    the descriptors as ``tests/test_torch_sift.py`` holds them."""
    got, want = runs[4][stage], runs[5][stage]
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.sum(-1).min() > 30
    np.testing.assert_allclose(got["pos"][valid], want["pos"][valid], rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(got["depth"][valid], want["depth"][valid], rtol=0,
                               atol=DEPTH_ATOL)
    a, b = got["desc"][valid], want["desc"][valid]
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    assert (cos <= DESC_COS).mean() <= DESC_OFF, np.sort(cos)[:5]


def test_engine_health_and_output(runs):
    port, _, outside, out_dir = runs[:4]
    assert outside == []
    assert os.listdir(out_dir) == ["drift_demo.json"]
    with open(out_dir / "drift_demo.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(port))
    assert not any(port["invariants"].values()) and port["alloc_failures"] == 0
    assert port["platform"] == "cpu" and port["peak_mem_gb"] is None
    assert len(port["prune_rounds_per_boundary"]) == port["keyframes"]
    assert port["revalidations"]["attempted"] >= port["revalidations"]["succeeded"] >= 0
