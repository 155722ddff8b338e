"""The port's engine end to end against the JAX engine, through the public
entry points (``process_frame`` / ``finish`` / ``trajectory`` /
``extract_mesh``), the port on the CPU.

One JAX run (module-scoped): the configuration of
``tests/test_pipeline_e2e.py``, nine frames, two boundaries, ``finish`` with
one extra solve (the dense term at the end). The host scheduler's state must
agree: validity flags and keyframe flags equal, counters equal, the chained
and the optimized trajectories within ``TRANS_TOL`` / ``ROT_TOL`` (both are
float32 pipelines whose SIFT and solver sums differ in order; the frame-step
test holds single frames to 2e-3, and two boundaries of bundle adjustment sit
between here). Then, on the port alone, the behaviours of
``tests/test_capacity.py`` (past keyframe capacity) and
``tests/test_recovery.py`` (a bad loop closure pruned, the keyframe lost,
queued and revalidated), and ``warmup``'s contract.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.pipeline.online import BundleFusion as TorchEngine
from bundlefusion_tpu_torch.solver.residuals import append_corrs
from bundlefusion_tpu_torch.tsdf.table import check_invariants
from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse
from tests.torch_parity import APP, BUNDLING, SIFT, port_intr, to_np

N_FRAMES = 9
TRANS_TOL = 5e-3   # metres
ROT_TOL = 5e-3     # radians
BUND = dict(BUNDLING, submap_size=4)


def _port_engine(max_keyframes=8, **bund):
    intr = default_intrinsics(160, 120)
    return TorchEngine(port_intr(intr), port.AppConfig(**APP),
                       port.BundlingConfig(**dict(BUND, **bund)),
                       sift_cfg=port.SiftConfig(**SIFT), max_keyframes=max_keyframes,
                       device="cpu")


def _pose_diff(A, B):
    dt = np.linalg.norm(A[:3, 3] - B[:3, 3])
    dR = A[:3, :3].T @ B[:3, :3]
    return dt, np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))


@pytest.fixture(scope="module")
def both_runs():
    intr = default_intrinsics(160, 120)
    seq = make_sequence(N_FRAMES, intr=intr)
    jeng = JaxEngine(intr, AppConfig(**APP), BundlingConfig(**BUND),
                     sift_cfg=SiftConfig(**SIFT), max_keyframes=8)
    teng = _port_engine()
    teng.warmup()
    outs = []
    for i in range(N_FRAMES):
        jeng.process_frame(seq["depth"][i], seq["color"][i])
        if i % 2:   # both ways in: arrays, or an uploaded handle
            outs.append(teng.process_frame(teng.upload_frame(seq["depth"][i], seq["color"][i])))
        else:
            outs.append(teng.process_frame(seq["depth"][i], seq["color"][i]))
    jeng.finish(extra_solves=1)
    teng.finish(extra_solves=1)
    return jeng, teng, seq, outs


def test_entry_points_and_return_keys(both_runs):
    _, teng, _, outs = both_runs
    for name in ("process_frame", "upload_frame", "finish", "warmup", "trajectory",
                 "extract_mesh"):
        assert callable(getattr(TorchEngine, name))
    assert all(set(o) == {"pose", "valid"} for o in outs)
    assert outs[0]["pose"].shape == (4, 4) and outs[0]["valid"].dtype == torch.bool
    assert all(bool(o["valid"]) for o in outs)
    assert teng.frame_idx == N_FRAMES and teng.trajectory().shape == (N_FRAMES, 4, 4)


def test_scheduler_state_matches(both_runs):
    jeng, teng, _, _ = both_runs
    assert teng.frame_valid == jeng.frame_valid == [True] * N_FRAMES
    np.testing.assert_array_equal(teng.keyframe_valid, jeng.keyframe_valid)
    assert teng.num_keyframes == jeng.num_keyframes == 2
    assert teng.keyframe_valid[:2].all()
    assert teng.retry_list == jeng.retry_list == []
    assert teng.lost_count == jeng.lost_count == 0
    assert teng.pairs_dropped_total == jeng.pairs_dropped_total == 0
    assert teng.reint_frames > 0 and jeng.reint_frames > 0
    assert teng._recorded_upto == jeng._recorded_upto == N_FRAMES
    assert [s["g"] for s in teng.boundary_stats] == [0, 1]
    # the first boundary has no global branch: the pack's read-back and
    # the local solve's one early-out read
    assert teng.boundary_stats[0]["host_reads"] <= 3


@pytest.mark.parametrize("which", ["sift_world", "complete_traj"])
def test_trajectories_match(both_runs, which):
    jeng, teng, _, _ = both_runs
    A, B = getattr(teng, which), getattr(jeng, which)
    assert len(A) == len(B) == N_FRAMES
    for f in range(N_FRAMES):
        assert np.isfinite(A[f]).all() and np.isfinite(B[f]).all(), f
        dt, ang = _pose_diff(A[f], np.asarray(B[f]))
        assert dt < TRANS_TOL and ang < ROT_TOL, (which, f, dt, ang)


def test_global_state_matches(both_runs):
    jeng, teng, _, _ = both_runs
    np.testing.assert_allclose(teng.glob.poses.numpy()[:2], to_np(jeng.glob.poses)[:2],
                               atol=TRANS_TOL)
    np.testing.assert_array_equal(teng.glob.local_valid.numpy(), to_np(jeng.glob.local_valid))
    np.testing.assert_allclose(teng.glob.local_traj.numpy()[:2], to_np(jeng.glob.local_traj)[:2],
                               atol=TRANS_TOL)
    n_t = int(teng.glob.corrs.valid_mask().sum())
    n_j = int(jeng.glob.corrs.valid_mask().sum())
    assert n_t > 0 and abs(n_t - n_j) <= max(2, 0.1 * n_j), (n_t, n_j)
    # fused keyframe 1: about the same number of keys survive
    k_t = int(teng.glob.keys.valid[1].sum())
    k_j = int(jeng.glob.keys.valid[1].sum())
    assert k_t > 10 and abs(k_t - k_j) <= max(3, 0.1 * k_j), (k_t, k_j)


def test_ate_mesh_invariants(both_runs):
    _, teng, seq, _ = both_runs
    traj = teng.trajectory()
    rmse, n = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])
    assert n == N_FRAMES and rmse < 0.06, rmse
    inv = check_invariants(teng.table)
    assert all(v == 0 for v in inv.values()), inv
    assert int(teng.table.num_alloc_failures) == 0
    verts, cols = teng.extract_mesh()
    assert len(verts) > 10_000 and len(cols) == len(verts)
    stages = teng.timing.totals()
    assert {"time_submap_local_solve", "time_submap_verify", "time_submap_fuse",
            "time_submap_global_match", "time_submap_global_solve", "time_submap_prune",
            "time_submap_pack", "time_finish", "time_finish_dense_solve"} <= set(stages)


def _tensors(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _tensors(v, prefix + f.name + ".")


def test_warmup_leaves_a_fresh_engine():
    fresh, warmed = _port_engine(), _port_engine()
    assert warmed.warmup() > 0
    for part in ("local", "glob", "store", "table"):
        for (name, a), (_, b) in zip(_tensors(getattr(warmed, part)),
                                     _tensors(getattr(fresh, part))):
            assert a.dtype == b.dtype and a.shape == b.shape, (part, name)
            av, bv = (x.view(torch.int16) if x.dtype == torch.uint16 else x for x in (a, b))
            same = torch.equal(torch.nan_to_num(av.float()), torch.nan_to_num(bv.float()))
            assert same, (part, name)
    assert not warmed.kf_valid_dev.any() and torch.equal(warmed.submap_base, torch.eye(4))
    assert warmed.frame_idx == 0 and warmed.frame_valid == [] and warmed.num_keyframes == 0
    assert warmed.traj_manager.records == [] and warmed.boundary_stats == []
    assert warmed.reint_frames == 0 and warmed.last_render is None
    with pytest.raises(AssertionError):
        both = _port_engine()
        both.frame_idx = 1
        both.warmup()


def test_no_device_means_no_engine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(port_intr(default_intrinsics(160, 120)))


G_CAP = 3
N_CAP = (G_CAP + 3) * 4 + 2


@pytest.fixture(scope="module")
def overflow_run():
    seq = make_sequence(N_CAP, intr=default_intrinsics(160, 120))
    eng = _port_engine(max_keyframes=G_CAP)
    for i in range(N_CAP):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    eng.finish(extra_solves=1)
    return eng, seq


def test_capacity_reached_and_every_frame_recorded(overflow_run):
    eng, _ = overflow_run
    assert eng.num_keyframes == G_CAP
    assert eng.trajectory().shape[0] == N_CAP and len(eng.frame_valid) == N_CAP
    # past capacity the window no longer rolls over: the anchor sits at sub_len
    assert eng._anchor_slot == eng.S - 1


def test_past_capacity_poses_sane(overflow_run):
    eng, seq = overflow_run
    traj = eng.trajectory()
    assert np.isfinite(traj).all(axis=(1, 2)).sum() >= N_CAP - 2
    rmse, n = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])
    assert n >= N_CAP - 2 and rmse < 0.12, rmse


def _inject_bad_closure(eng, K=8):
    """Bogus (kf1, kf0) corrs, residual ~0.5 m >> opt_max_res_thresh."""
    rng = np.random.default_rng(0)
    p_i = rng.uniform(-0.5, 0.5, (K, 3)).astype(np.float32) + np.float32([0, 0, 1.5])
    p_j = p_i + np.array([0.5, 0.3, 0.0], np.float32)
    c0 = int(eng.glob.corrs.count)
    append_corrs(eng.glob.corrs, torch.full((K,), 1, dtype=torch.int32),
                 torch.zeros(K, dtype=torch.int32), torch.from_numpy(p_i),
                 torch.from_numpy(p_j), torch.ones(K, dtype=torch.bool))
    return slice(c0, c0 + K)


def test_bad_loop_closure_pruned_and_ate_recovers():
    """The prune rounds of the next boundary invalidate the injected pair
    (guided removal on, as in ``tests/test_recovery.py``); every keyframe is
    valid at the end and the trajectory is as good as a clean run's."""
    n = 17
    seq = make_sequence(n, intr=default_intrinsics(160, 120))
    eng = _port_engine(use_guided_remove=True)
    for i in range(9):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    injected = _inject_bad_closure(eng)
    for i in range(9, n):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    eng.finish(extra_solves=1)
    assert (eng.glob.corrs.img_i[injected] == -1).all()
    assert [s["prune_rounds"] for s in eng.boundary_stats][:3] == [0, 0, 1]
    assert eng.keyframe_valid[: eng.num_keyframes].all(), (eng.keyframe_valid, eng.retry_list)
    traj = eng.trajectory()
    rmse, n_valid = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])
    assert n_valid >= n - 2 and rmse < 0.06, (n_valid, rmse)
    assert all(v == 0 for v in check_invariants(eng.table).values())


def test_lost_keyframe_is_queued_and_revalidated():
    """Keyframe 1 loses its pose and its correspondences (as a solve's
    comprehensive invalidation leaves it) and waits in the retry list: the
    next boundary re-matches it against the valid keyframes, appends the
    fresh correspondences and restores it. A keyframe with nothing to match
    stays queued."""
    from bundlefusion_tpu_torch.solver.residuals import invalidate_frame

    n = 13
    seq = make_sequence(n, intr=default_intrinsics(160, 120))
    eng = _port_engine()
    for i in range(9):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    assert eng.keyframe_valid[:2].all()
    invalidate_frame(eng.glob.corrs, 1)
    eng.glob.keys.frame_valid[1] = False
    eng.keyframe_valid[1] = False
    eng.kf_valid_dev[1] = False
    eng.retry_list.append(1)
    live0 = int(eng.glob.corrs.valid_mask().sum())
    for i in range(9, 12):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    assert eng.retry_list == [1] and not eng.keyframe_valid[1]   # no boundary yet
    eng.process_frame(seq["depth"][12], seq["color"][12])         # boundary g = 2
    assert eng.retry_list == [] and eng.retry_attempts == {1: 1}
    assert eng.keyframe_valid[:3].all() and bool(eng.kf_valid_dev[1])
    assert int(eng.glob.corrs.valid_mask().sum()) > live0
    # keyframe 0 has no earlier keyframe to match: it stays queued
    eng.retry_list.append(0)
    eng._try_revalidation()
    assert eng.retry_list == [0] and eng.retry_attempts[0] == 1
    eng.retry_list.clear()
    eng.glob.keys.frame_valid[0] = True     # the failed attempt switched it off
    eng.finish(extra_solves=1)
    traj = eng.trajectory()
    rmse, n_valid = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])
    assert n_valid == n and rmse < 0.06, (n_valid, rmse)
