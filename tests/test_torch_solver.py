"""The port's sparse Gauss-Newton solver against the JAX one.

The same seeded numpy pose graphs and correspondence stores go through
``bundlefusion_tpu.solver.gn_pcg`` and ``bundlefusion_tpu_torch.solver.gn_pcg``
(on the CPU), with both linear steps (direct LU and PCG). Integer structure
(sort order, segments, pair lists, kill masks, counts, dropped) must be
equal; float results agree within the tolerances below: both sides are
float32 and differ in the order of their sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.geometry import matrix_to_pose, pose_to_matrix
from bundlefusion_tpu.solver import gn_pcg as jgn
from bundlefusion_tpu.solver import residuals as jres
from bundlefusion_tpu_torch.solver import gn_pcg as tgn
from bundlefusion_tpu_torch.solver import residuals as tres
from bundlefusion_tpu_torch.utils import host_reads
from tests.test_solver import build_pose_graph
from tests.test_solver_scale import big_ring_graph
from tests.torch_parity import port_corrs, t, to_np

POSE_ATOL = 2e-4      # solved poses, JAX vs port
BLOCK_RTOL = 1e-4     # JtJ / Jtr blocks, relative to the largest entry
LINEARS = ["dense", "pcg"]


def _graph(seed=0, **kw):
    rng = np.random.default_rng(seed)
    gt, store = build_pose_graph(rng, **kw)
    gt_poses = np.stack([to_np(matrix_to_pose(jnp.asarray(g))) for g in gt]).astype(np.float32)
    return rng, gt, gt_poses, store


def _both(init, valid, store, jp, tp):
    jout, jst = jgn.solve_sparse(jnp.asarray(init), jnp.asarray(valid), store, jp)
    tout, tst = tgn.solve_sparse(t(init), t(valid), port_corrs(store), tp)
    return to_np(jout), jst, tout.numpy(), tst


def _params(linear, **kw):
    return jgn.SolverParams(linear=linear, **kw), tgn.SolverParams(linear=linear, **kw)


@pytest.mark.parametrize("linear", LINEARS)
def test_recovers_perturbed_poses(linear):
    rng, gt, gt_poses, store = _graph()
    n = len(gt)
    init = gt_poses.copy()
    init[1:] += rng.normal(size=(n - 1, 6)).astype(np.float32) * 0.05
    jout, jst, tout, tst = _both(init, np.ones(n, bool), store,
                                 *_params(linear, num_gn=5, num_pcg=50))
    assert float(tst.final_cost) < 1e-6
    assert float(tst.final_cost) < float(tst.initial_cost) * 1e-3
    np.testing.assert_allclose(float(tst.initial_cost), float(jst.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(tout, jout, atol=POSE_ATOL)
    for i in range(n):
        T = to_np(pose_to_matrix(jnp.asarray(tout[i])))
        np.testing.assert_allclose(T, gt[i], atol=5e-3)
    assert int(tst.num_pairs_dropped) == int(jst.num_pairs_dropped) == 0


@pytest.mark.parametrize("linear", LINEARS)
def test_noise_floor(linear):
    rng, gt, gt_poses, store = _graph(noise=0.005)
    n = len(gt)
    init = gt_poses.copy()
    init[1:] += rng.normal(size=(n - 1, 6)).astype(np.float32) * 0.03
    jout, jst, tout, tst = _both(init, np.ones(n, bool), store,
                                 *_params(linear, num_gn=4, num_pcg=60))
    c = float(tst.final_cost)
    assert c / int(store.count) < 3 * (2 * 0.005**2) * 4
    np.testing.assert_allclose(c, float(jst.final_cost), rtol=1e-3)
    np.testing.assert_allclose(tout, jout, atol=POSE_ATOL)
    np.testing.assert_allclose(float(tst.max_residual), float(jst.max_residual), rtol=1e-3)
    assert int(tst.max_residual_corr) == int(jst.max_residual_corr)


@pytest.mark.parametrize("linear", LINEARS)
def test_frame0_fixed(linear):
    _, gt, gt_poses, store = _graph()
    init = gt_poses.copy()
    init[1:] += 0.05
    jout, _, tout, _ = _both(init, np.ones(len(gt), bool), store, *_params(linear))
    np.testing.assert_array_equal(tout[0], init[0])
    np.testing.assert_allclose(tout, jout, atol=POSE_ATOL)


@pytest.mark.parametrize("linear", LINEARS)
def test_frozen_invalid_pose(linear):
    _, gt, gt_poses, store = _graph()
    init = gt_poses.copy()
    init[1:] += 0.02
    valid = np.ones(len(gt), bool)
    valid[3] = False
    store2 = jres.invalidate_frame(store, 3)
    jout, _, tout, _ = _both(init, valid, store2, *_params(linear))
    np.testing.assert_array_equal(tout[3], init[3])
    np.testing.assert_allclose(tout, jout, atol=POSE_ATOL)


def test_max_residual_and_invalidation():
    _, gt, gt_poses, store = _graph()
    pi = to_np(store.p_i).copy()
    mask = (to_np(store.img_i) == 1) & (to_np(store.img_j) == 0)
    pi[mask] += 0.5
    store2 = store._replace(p_i=jnp.asarray(pi))
    ts = port_corrs(store2)
    jmr, jidx = jgn.max_residual(jnp.asarray(gt_poses), store2)
    tmr, tidx = tgn.max_residual(t(gt_poses), ts)
    assert float(tmr) > 0.2 and mask[int(tidx)]
    np.testing.assert_allclose(float(tmr), float(jmr), rtol=1e-5)
    assert int(tidx) == int(jidx)
    jh = jgn.count_high_residuals(jnp.asarray(gt_poses), store2, 0.02)
    th = tgn.count_high_residuals(t(gt_poses), ts, 0.02)
    assert (int(th[0]), int(th[1])) == (int(jh[0]), int(jh[1])) == (mask.sum(), int(store.count))
    r_j, v_j = jgn.compute_residuals(jnp.asarray(gt_poses), store2)
    r_t, v_t = tgn.compute_residuals(t(gt_poses), ts)
    np.testing.assert_allclose(r_t.numpy(), to_np(r_j), atol=1e-6)
    np.testing.assert_array_equal(v_t.numpy(), to_np(v_j))
    tres.invalidate_image_pair(ts, 0, 1)
    assert float(tgn.max_residual(t(gt_poses), ts)[0]) < 0.01
    # an empty store: nothing valid
    empty = tres.create_corr_store(64, "cpu")
    mr, idx = tgn.max_residual(t(gt_poses), empty)
    assert float(mr) == -1.0 and int(idx) == 0


def _holey_store():
    """48K-row store: 16384 corrs on pair (1, 0), then 4000 on (2, 0) with a
    residual of 0.5, then frame 1 invalidated: the live corrs all sit past
    the first 16384 rows while the live count is 4000."""
    C = 3 * 16384
    store = jres.create_corr_store(C)
    z = jnp.zeros((16384, 3), jnp.float32)
    store = jres.append_corrs(store, jnp.ones(16384, jnp.int32), jnp.zeros(16384, jnp.int32),
                              z, z, jnp.ones(16384, bool))
    n_tail = 4000
    pts = jnp.asarray(np.random.default_rng(2).uniform(-1, 1, (n_tail, 3)).astype(np.float32))
    store = jres.append_corrs(store, jnp.full((n_tail,), 2, jnp.int32),
                              jnp.zeros(n_tail, jnp.int32), pts.at[:, 0].add(0.5), pts,
                              jnp.ones(n_tail, bool))
    return jres.invalidate_frame(store, 1), n_tail


def test_passes_scan_to_the_cursor_not_the_live_count():
    store, n_tail = _holey_store()
    ts = port_corrs(store)
    assert int(ts.count) == 16384 + n_tail and int(ts.valid_mask().sum()) == n_tail
    poses = np.zeros((4, 6), np.float32)
    before = host_reads["count"]
    c = float(tgn.cost(t(poses), ts))
    assert host_reads["count"] == before + 1   # the cursor
    np.testing.assert_allclose(c, n_tail * 0.25, rtol=1e-5)
    np.testing.assert_allclose(c, float(jgn.cost(jnp.asarray(poses), store)), rtol=1e-6)
    mr, idx = tgn.max_residual(t(poses), ts)
    jmr, jidx = jgn.max_residual(jnp.asarray(poses), store)
    np.testing.assert_allclose(float(mr), 0.5, rtol=1e-5)
    assert int(idx) == int(jidx) >= 16384
    nh, nv = tgn.count_high_residuals(t(poses), ts, 0.02)
    assert int(nh) == int(nv) == n_tail


@pytest.mark.parametrize("linear", LINEARS)
def test_solve_on_holey_store(linear):
    """A solve over the holey store: the holes ride with their segments."""
    store, _ = _holey_store()
    init = np.zeros((4, 6), np.float32)
    init[2, 3] = 0.1
    jout, jst, tout, tst = _both(init, np.ones(4, bool), store,
                                 *_params(linear, num_gn=2, num_pcg=20, max_pairs=16))
    np.testing.assert_allclose(tout, jout, atol=POSE_ATOL)
    np.testing.assert_allclose(tout[2, 3], -0.5, atol=1e-4)
    assert float(tst.final_cost) < 1e-6


def _assert_sorted_equal(tsc, jsc, exact_points=True):
    for name in ("img_i", "img_j", "valid", "seg_id", "starts", "ends", "pair_i", "pair_j",
                 "pair_valid"):
        np.testing.assert_array_equal(getattr(tsc, name).numpy(), to_np(getattr(jsc, name)), name)
    assert int(tsc.dropped) == int(jsc.dropped)
    np.testing.assert_array_equal(tsc.p_i.numpy(), to_np(jsc.p_i))
    np.testing.assert_array_equal(tsc.p_j.numpy(), to_np(jsc.p_j))


def _chronological_pairs(C, n_pairs, per_pair, seed=0):
    rng = np.random.default_rng(seed)
    store = jres.create_corr_store(C)
    for p in range(n_pairs):
        pts = jnp.asarray(rng.uniform(-1, 1, size=(per_pair, 3)).astype(np.float32))
        store = jres.append_corrs(store, jnp.full((per_pair,), p + 1, jnp.int32),
                                  jnp.zeros(per_pair, jnp.int32), pts, pts,
                                  jnp.ones(per_pair, bool))
    return store


def test_working_set_overflow_is_pair_budgeted():
    store = _chronological_pairs(512, 16, 24)
    working, n_frames = 128, 40
    jsc = jgn.sort_corrs_by_pair(store, n_frames, max_pairs=64, working=working)
    tsc = tgn.sort_corrs_by_pair(port_corrs(store), n_frames, max_pairs=64, working=working)
    _assert_sorted_equal(tsc, jsc)
    assert int(tsc.dropped) == 16 * 24 - working
    kept_i = tsc.img_i.numpy()[tsc.valid.numpy()]
    counts = [int((kept_i == p + 1).sum()) for p in range(16)]
    assert all(working // 16 <= c <= working // 16 + 1 for c in counts), counts
    # under capacity the cheap path keeps everything
    tsc2 = tgn.sort_corrs_by_pair(port_corrs(store), n_frames, max_pairs=64, working=511)
    _assert_sorted_equal(tsc2, jgn.sort_corrs_by_pair(store, n_frames, max_pairs=64, working=511))
    assert int(tsc2.dropped) == 0 and int(tsc2.valid.sum()) == 16 * 24


def test_working_set_overflow_prefers_newest_pairs():
    store = _chronological_pairs(1024, 512, 1)
    jsc = jgn.sort_corrs_by_pair(store, 600, max_pairs=600, working=64)
    tsc = tgn.sort_corrs_by_pair(port_corrs(store), 600, max_pairs=600, working=64)
    _assert_sorted_equal(tsc, jsc)
    kept = sorted(tsc.img_i.numpy()[tsc.valid.numpy()].tolist())
    assert kept == list(range(512 - 64 + 1, 512 + 1))


def _shuffled_store(seed=3, n_frames=8, holes=True):
    """A store whose rows are NOT pid-sorted, with invalidation holes."""
    rng, gt, gt_poses, store = _graph(seed, n_frames=n_frames)
    n = int(store.count)
    perm = rng.permutation(n)
    d = {k: to_np(v) for k, v in store._asdict().items()}
    for k in ("img_i", "img_j", "p_i", "p_j", "key_i", "key_j"):
        d[k] = d[k].copy()
        d[k][:n] = d[k][:n][perm]
    if holes:
        d["img_i"][rng.choice(n, n // 7, replace=False)] = -1
    store = jres.CorrStore(**{k: jnp.asarray(v) for k, v in d.items()})
    return rng, gt_poses, store


def test_sort_corrs_by_pair_matches():
    _, _, store = _shuffled_store()
    for max_pairs in (64, 5):      # 5: pairs beyond the cap are dropped
        jsc = jgn.sort_corrs_by_pair(store, 8, max_pairs)
        tsc = tgn.sort_corrs_by_pair(port_corrs(store), 8, max_pairs)
        _assert_sorted_equal(tsc, jsc)
    assert int(tsc.dropped) > 0


def test_sort_free_path_above_65536_rows():
    """A large sorted-by-construction store keeps its order (holes in
    place); an out-of-order append falls back to the sort. Both match."""
    C = 2 * 65536
    rng = np.random.default_rng(5)
    n = 3000
    img_i = np.sort(rng.integers(1, 20, n)).astype(np.int32)
    img_j = np.zeros(n, np.int32)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    for out_of_order in (False, True):
        ii = img_i.copy()
        if out_of_order:
            ii[-5:] = 2
        ii[rng.choice(n - 10, 200, replace=False)] = -1
        arrs = dict(img_i=np.full(C, -1, np.int32), img_j=np.full(C, -1, np.int32),
                    p_i=np.zeros((C, 3), np.float32), p_j=np.zeros((C, 3), np.float32),
                    key_i=np.zeros(C, np.int32), key_j=np.zeros(C, np.int32),
                    count=np.asarray(n, np.int32))
        arrs["img_i"][:n], arrs["img_j"][:n] = ii, img_j
        arrs["p_i"][:n], arrs["p_j"][:n] = pts, pts + 0.01
        store = jres.CorrStore(**{k: jnp.asarray(v) for k, v in arrs.items()})
        jsc = jgn.sort_corrs_by_pair(store, 32, 64)
        tsc = tgn.sort_corrs_by_pair(tres.corr_store_from_numpy(arrs, "cpu"), 32, 64)
        _assert_sorted_equal(tsc, jsc)
        kept_order = bool((tsc.img_i.numpy()[:n] == ii).all())
        assert kept_order != out_of_order


@pytest.fixture(scope="module")
def presorted():
    rng, gt_poses, store = _shuffled_store()
    poses = gt_poses + rng.normal(size=gt_poses.shape).astype(np.float32) * 0.02
    poses[0] = gt_poses[0]
    jp, tp = _params("dense", max_pairs=64)
    jprob = jgn.presort_corrs(store, 8, jp)
    tprob = tgn.presort_corrs(port_corrs(store), 8, tp)
    return poses, store, jprob, tprob, jp, tp


def test_presort_matches(presorted):
    _, _, jprob, tprob, _, _ = presorted
    _assert_sorted_equal(tprob.sc, jprob.sc)
    assert int(tprob.n_live) == int(jprob.n_live) <= tprob.bound
    for name in ("pair_i", "pair_j", "order_i", "seg_i", "order_j", "seg_j"):
        np.testing.assert_array_equal(getattr(tprob.ps, name).numpy(),
                                      to_np(getattr(jprob.ps, name)), name)
    np.testing.assert_array_equal(tprob.inv_i.numpy(), to_np(jprob.inv_i))
    np.testing.assert_array_equal(tprob.inv_j.numpy(), to_np(jprob.inv_j))


def test_build_sparse_pair_system_and_reductions_match(presorted):
    poses, _, jprob, tprob, _, _ = presorted
    jH, jb = jgn.build_sparse_pair_system(jnp.asarray(poses), jprob.sc, jnp.float32(1.0))
    tH, tb = tgn.build_sparse_pair_system(t(poses), tprob.sc, 1.0, n_live=tprob.bound)
    scale = np.abs(to_np(jH)).max()
    np.testing.assert_allclose(tH.numpy(), to_np(jH), atol=BLOCK_RTOL * scale)
    np.testing.assert_allclose(tb.numpy(), to_np(jb), atol=BLOCK_RTOL * np.abs(to_np(jb)).max())
    # a bound below the capacity gives the same blocks as no bound
    tH2, _ = tgn.build_sparse_pair_system(t(poses), tprob.sc, 1.0)
    np.testing.assert_array_equal(tH2.numpy(), tH.numpy())
    x = np.random.default_rng(1).normal(size=(8, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tgn._pair_matvec_f32(tH, tprob.ps, t(x)).numpy(),
        to_np(jgn._pair_matvec_f32(jH, jprob.ps, jnp.asarray(x))), atol=BLOCK_RTOL * scale * 10)
    np.testing.assert_allclose(tgn._pair_precond(tH, tprob.ps, 8).numpy(),
                               to_np(jgn._pair_precond(jH, jprob.ps, 8)),
                               atol=BLOCK_RTOL * scale * 10)
    np.testing.assert_allclose(tgn._pair_rhs(tb, tprob.ps, 8).numpy(),
                               to_np(jgn._pair_rhs(jb, jprob.ps, 8)),
                               atol=BLOCK_RTOL * np.abs(to_np(jb)).max() * 10)


def test_dense_reduced_solve_matches(presorted):
    poses, _, jprob, tprob, _, _ = presorted
    jH, jb = jgn.build_sparse_pair_system(jnp.asarray(poses), jprob.sc, jnp.float32(1.0))
    free = np.ones((8, 1), np.float32)
    free[0] = 0
    free[5] = 0
    jd = jgn._dense_reduced_solve(jH, jb, jprob, jnp.asarray(free), 8)
    td = tgn._dense_reduced_solve(t(to_np(jH)), t(to_np(jb)), tprob, t(free), 8)
    np.testing.assert_allclose(td.numpy(), to_np(jd), atol=1e-5)
    assert not td[0].any() and not td[5].any() and td[1].abs().max() > 1e-3
    # a singular system: the step becomes no update, and is counted
    before = tgn.lu_zero_steps("cpu")
    bad = t(to_np(jH)).clone()
    bad[0, 0, 0] = float("nan")
    zero = tgn._dense_reduced_solve(bad, t(to_np(jb)), tprob, t(free), 8)
    assert not zero.any() and tgn.lu_zero_steps("cpu") == before + 1


def test_max_residual_sorted_and_pair_kills_match(presorted):
    poses, store, jprob, tprob, _, _ = presorted
    jm = jgn.max_residual_sorted(jnp.asarray(poses), jprob)
    tm = tgn.max_residual_sorted(t(poses), tprob)
    np.testing.assert_allclose(float(tm[0]), float(jm[0]), rtol=1e-5)
    fa, fb = int(tm[1]), int(tm[2])
    assert (fa, fb) == (int(jm[1]), int(jm[2])) and fa >= 0
    jp2 = jgn.invalidate_pair_sorted(jprob, fa, fb)
    tp2 = tgn.invalidate_pair_sorted(tprob, tm[1], tm[2])
    np.testing.assert_array_equal(tp2.sc.valid.numpy(), to_np(jp2.sc.valid))
    assert int(tp2.sc.valid.sum()) < int(tprob.sc.valid.sum())
    np.testing.assert_array_equal(tgn.corr_counts_per_frame_sorted(tp2, 8).numpy(),
                                  to_np(jgn.corr_counts_per_frame_sorted(jp2, 8)))
    # over the whole store the counts equal the store's own twin
    np.testing.assert_array_equal(tgn.corr_counts_per_frame_sorted(tprob, 8).numpy(),
                                  tres.corr_counts_per_frame(port_corrs(store), 8).numpy())


def test_guided_kill_mask_matches():
    """A 16-frame graph with one bad long-range pair of the newest frame."""
    rng, gt, gt_poses, store = _graph(7, n_frames=16)
    n = 24
    world = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32) + [0, 0, 2]
    inv15, inv2 = np.linalg.inv(gt[15]), np.linalg.inv(gt[2])
    p15 = world @ inv15[:3, :3].T + inv15[:3, 3] + 0.4      # a bad loop closure
    p2 = world @ inv2[:3, :3].T + inv2[:3, 3]
    store = jres.append_corrs(store, jnp.full((n,), 15, jnp.int32), jnp.full((n,), 2, jnp.int32),
                              jnp.asarray(p15, jnp.float32), jnp.asarray(p2, jnp.float32),
                              jnp.ones(n, bool))
    prev = gt_poses.copy()
    prev[15, 3:] += 0.6
    jp, tp = _params("dense", max_pairs=256)
    jprob = jgn.presort_corrs(store, 16, jp)
    tprob = tgn.presort_corrs(port_corrs(store), 16, tp)
    jmr = jgn.max_residual_sorted(jnp.asarray(gt_poses), jprob)[0]
    tmr = tgn.max_residual_sorted(t(gt_poses), tprob)[0]
    jk = jgn.guided_kill_mask(jnp.asarray(gt_poses), jnp.asarray(prev), jprob, 15, jmr, 16)
    tk = tgn.guided_kill_mask(t(gt_poses), t(prev), tprob, 15, tmr, 16)
    np.testing.assert_array_equal(tk.numpy(), to_np(jk))
    assert tk.numpy().nonzero()[0].tolist() == [15 * 16 + 2]
    np.testing.assert_array_equal(tgn.apply_pair_kill_sorted(tprob, tk, 16).sc.valid.numpy(),
                                  to_np(jgn.apply_pair_kill_sorted(jprob, jk, 16).sc.valid))
    ts = port_corrs(store)
    tgn.apply_pair_kill_store(ts, tk, 16)
    np.testing.assert_array_equal(ts.img_i.numpy(),
                                  to_np(jgn.apply_pair_kill_store(store, jk, 16).img_i))
    assert int(ts.valid_mask().sum()) == int(store.count) - n


@pytest.mark.parametrize("linear", LINEARS)
def test_solve_512_keyframes_converges(linear):
    rng = np.random.default_rng(0)
    N = 512
    gt, store = big_ring_graph(rng, N)
    init = gt + rng.normal(size=gt.shape).astype(np.float32) * 0.01
    init[0] = gt[0]
    ts = port_corrs(store)
    poses, stats = tgn.solve_sparse(t(init), torch.ones(N, dtype=torch.bool), ts,
                                    tgn.SolverParams(num_gn=3, num_pcg=60, max_pairs=2048,
                                                     linear=linear))
    assert int(stats.num_pairs_dropped) == 0
    c0 = float(tgn.cost(t(init), ts))
    np.testing.assert_allclose(c0, float(jgn.cost(jnp.asarray(init), store)), rtol=1e-4)
    assert float(stats.final_cost) < 1e-3 * c0
    assert np.abs(poses.numpy() - gt).max() < 5e-3


def test_pair_overflow_accounted():
    gt, store = big_ring_graph(np.random.default_rng(1), 64)
    jp, tp = _params("auto", num_gn=1, num_pcg=10, max_pairs=32)
    _, jst = jgn.solve_sparse(jnp.asarray(gt), jnp.ones((64,), bool), store, jp)
    _, tst = tgn.solve_sparse(t(gt), torch.ones(64, dtype=torch.bool), port_corrs(store), tp)
    assert int(tst.num_pairs_dropped) == int(jst.num_pairs_dropped) > 0
