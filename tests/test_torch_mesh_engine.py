"""The port's engine over a mesh of 2 ``gloo`` ranks on the CPU against the
JAX engine over a 2-device mesh (of the 8 virtual CPU devices), through the
public entry points.

The configuration is the JAX package's multi-device dry run
(``__graft_entry__.py``: the small pipeline configuration, a global corr
store of 128 rows per device) with a keyframe capacity of 4, i.e. 2 slots
per rank. 14 frames make boundaries 0-2 in ``process_frame`` and the
trailing partial submap (keyframe 3) in ``finish``, so each rank's
chunk of the keyframe matching takes part. At G <= 2048 both mesh engines
solve the keyframe graph by PCG (the single-device engines by LU), so the
port is held against the JAX mesh engine: the same keyframe flags and count,
the same frames valid, and the optimized trajectory within
``test_torch_engine.py``'s ``TRANS_TOL`` / ``ROT_TOL``. On the port alone:
``replicas_agree()`` after every boundary and at the end, no collective on a
frame that is not a boundary, ``save`` then ``load(mesh=)``, the keyframe
capacity check, and that a 1-rank mesh takes the single-device path.

One spawn of the 2 ranks runs every port scenario (module fixture).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.parallel.ba_sharded import make_mesh as jax_make_mesh
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.parallel.mesh import Mesh, run_ranks
from bundlefusion_tpu_torch.pipeline.online import BundleFusion as TorchEngine
from tests.test_torch_engine import ROT_TOL, TRANS_TOL, _pose_diff
from tests.torch_mesh_workers import engine_scenarios

N_FRAMES = 14
N_RANKS = 2
SUB_LEN = 4
APP = dict(integration_width=80, integration_height=60, sdf_voxel_size=0.03,
           sdf_truncation=0.09, hash_num_sdf_blocks=8192, hash_key_capacity=16384,
           visible_blocks_cap=8192)
BUND = dict(width_sift=160, height_sift=120, submap_size=SUB_LEN, downsampled_width=40,
            downsampled_height=30, max_local_corr=2048, max_global_corr=128 * N_RANKS,
            min_num_matches_local=4, min_num_matches_global=4)
SIFT = dict(num_octaves=3, target_keys=96, max_candidates_per_octave=256, min_scale=1.0,
            dog_thresh=0.004)
G = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    intr = default_intrinsics(160, 120)
    seq = {k: np.asarray(v) for k, v in make_sequence(N_FRAMES, intr=intr).items()
           if k in ("depth", "color")}
    cfg = dict(intr=dataclasses.asdict(intr), app=APP, bundling=BUND, sift=SIFT,
               max_keyframes=G)
    ranks = run_ranks(engine_scenarios, N_RANKS, seq, N_FRAMES, cfg,
                      str(tmp_path_factory.mktemp("ckpt")), device="cpu",
                      init_method="file://" + str(tmp_path_factory.mktemp("rdzv") / "store"))
    jeng = JaxEngine(intr, AppConfig(**APP), BundlingConfig(**BUND), sift_cfg=SiftConfig(**SIFT),
                     max_keyframes=G, mesh=jax_make_mesh(jax.devices()[:N_RANKS]))
    for i in range(N_FRAMES):
        jeng.process_frame(seq["depth"][i], seq["color"][i])
    jeng.finish(extra_solves=1)
    return ranks, jeng, seq


def test_same_keyframes_and_flags_as_jax_mesh(runs):
    ranks, jeng, _ = runs
    r0 = ranks[0]
    assert not r0["single_path"]
    assert r0["num_keyframes"] == jeng.num_keyframes == G
    np.testing.assert_array_equal(r0["kf_valid"], jeng.keyframe_valid)
    assert r0["kf_valid"][:3].all()
    assert r0["frame_valid"] == list(jeng.frame_valid)


def test_trajectory_matches_jax_mesh(runs):
    ranks, jeng, _ = runs
    tt, jt = ranks[0]["traj"], jeng.trajectory()
    assert tt.shape == jt.shape == (N_FRAMES, 4, 4)
    ok_t, ok_j = np.isfinite(tt).all((1, 2)), np.isfinite(jt).all((1, 2))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_t.sum() >= 3 * SUB_LEN
    for f in np.where(ok_t)[0]:
        dt, dr = _pose_diff(tt[f], jt[f])
        assert dt < TRANS_TOL and dr < ROT_TOL, (f, dt, dr)


def test_replicas_agree_at_every_boundary(runs):
    ranks, _, _ = runs
    for r in ranks:
        # three boundaries in process_frame, then the end of finish
        assert r["agree"] == [True] * 4, r["agree"]
    np.testing.assert_array_equal(ranks[0]["poses"], ranks[1]["poses"])
    assert ranks[0]["corr_count"] == ranks[1]["corr_count"]
    np.testing.assert_array_equal(ranks[0]["kf_valid"], ranks[1]["kf_valid"])


def test_collectives_only_at_boundaries(runs):
    ranks, _, _ = runs
    for r in ranks:
        calls = r["calls_per_frame"]
        for f, n in enumerate(calls):
            boundary = f > 0 and f % SUB_LEN == 0
            assert (n > 0) == boundary, (r["rank"], f, n)


def test_only_rank0_returns_poses(runs):
    ranks, _, _ = runs
    assert not any(ranks[0]["pose_is_none"])
    assert all(ranks[1]["pose_is_none"])
    assert ranks[0]["loaded_holds_map"] and not ranks[1]["loaded_holds_map"]


def test_save_then_load_onto_the_mesh(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert r["loaded_agree"] and r["loaded_equal"]


def test_keyframe_capacity_must_split_over_the_ranks(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert r["capacity_error"] == (f"keyframe capacity {G * N_RANKS + 1} must divide the "
                                       f"mesh size {N_RANKS}")


def test_one_rank_mesh_takes_the_single_device_path(runs):
    """A mesh of one rank needs no process group: it never communicates, and
    the engine runs exactly as without a mesh."""
    _, _, seq = runs
    intr = port.CameraIntrinsics(**dataclasses.asdict(default_intrinsics(160, 120)))
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                backend="gloo")
    engines = [TorchEngine(intr, port.AppConfig(**APP), port.BundlingConfig(**BUND),
                           sift_cfg=port.SiftConfig(**SIFT), max_keyframes=G, mesh=m,
                           device="cpu") for m in (mesh, None)]
    assert not engines[0]._use_mesh and engines[0]._is_root
    for i in range(SUB_LEN + 1):
        for eng in engines:
            eng.process_frame(seq["depth"][i], seq["color"][i])
    assert mesh.stats["calls"] == 0
    np.testing.assert_array_equal(engines[0].trajectory(), engines[1].trajectory())
    assert engines[0].replicas_agree()
