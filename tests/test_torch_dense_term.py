"""The port's dense (point-to-plane + photometric) BA term against the JAX one.

Three rendered 40x30 frames of the synthetic scene, 4 cm apart, built once
with the JAX package and carried into the port as numpy. The pair list,
association counts and masks must be equal; the per-pair JtJ / Jtr blocks
agree within ``BLOCK_RTOL`` of the largest entry (float32, different order
of the sums over 1200 pixels); a dense-only ``solve_bundle`` agrees within
``POSE_ATOL`` with both linear steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.solver import dense_term as jdt
from bundlefusion_tpu.solver import gn_pcg as jgn
from bundlefusion_tpu.solver.residuals import create_corr_store
from bundlefusion_tpu_torch.solver import dense_term as tdt
from bundlefusion_tpu_torch.solver import gn_pcg as tgn
from tests.test_dense_term import INTR, make_cache
from tests.test_solver import build_pose_graph
from tests.torch_parity import port_cache, port_corrs, port_intr, t, to_np
from bundlefusion_tpu.geometry import matrix_to_pose

BLOCK_RTOL = 2e-4
POSE_ATOL = 2e-4
KW = dict(overlap_min_hits=5, min_corr_per_pair=100, max_pairs=8, depth_min=0.2)
JP, TP = jdt.DenseTermParams(**KW), tdt.DenseTermParams(**KW)
TINTR = port_intr(INTR)


@pytest.fixture(scope="module")
def three_frames():
    poses = []
    for i in range(3):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.04 * i
        poses.append(T)
    cache = make_cache(poses)
    gt = np.stack([to_np(matrix_to_pose(jnp.asarray(T))) for T in poses]).astype(np.float32)
    return cache, port_cache(cache), gt


def _systems(three_frames, poses, w_color=0.0):
    cache, tcache, _ = three_frames
    ones = np.ones(3, bool)
    jpairs, jmask = jdt.find_overlapping_pairs(jnp.asarray(poses), jnp.asarray(ones), cache,
                                               INTR, JP)
    tpairs, tmask = tdt.find_overlapping_pairs(t(poses), t(ones), tcache, TINTR, TP)
    jsys = jdt.build_dense_system(jnp.asarray(poses), jpairs, jmask, cache, INTR, JP, 1.0,
                                  w_color)
    tsys = tdt.build_dense_system(t(poses), tpairs, tmask, tcache, TINTR, TP, 1.0, w_color)
    return (jpairs, jmask, jsys), (tpairs, tmask, tsys)


def test_find_overlapping_pairs(three_frames):
    (jpairs, jmask, _), (tpairs, tmask, _) = _systems(three_frames, three_frames[2])
    np.testing.assert_array_equal(tmask.numpy(), to_np(jmask))
    np.testing.assert_array_equal(tpairs.numpy(), to_np(jpairs))
    assert set(map(tuple, tpairs.numpy()[tmask.numpy()])) == {(0, 1), (0, 2), (1, 2)}


def test_find_overlapping_pairs_respects_validity_and_angle(three_frames):
    cache, tcache, gt = three_frames
    poses = gt.copy()
    poses[2, 1] = 1.2        # frame 2 looks away: over 2 * 0.52 rad from the others
    valid = np.array([True, False, True])
    for pz, vz in ((gt, valid), (poses, np.ones(3, bool))):
        jpairs, jmask = jdt.find_overlapping_pairs(jnp.asarray(pz), jnp.asarray(vz), cache,
                                                   INTR, JP)
        tpairs, tmask = tdt.find_overlapping_pairs(t(pz), t(vz), tcache, TINTR, TP)
        np.testing.assert_array_equal(tmask.numpy(), to_np(jmask))
        np.testing.assert_array_equal(tpairs.numpy(), to_np(jpairs))
        assert int(tmask.sum()) == 1


def test_find_overlapping_pairs_candidates_only_path(three_frames, monkeypatch):
    """Above the chunk size the overlap test runs over the candidates only;
    the list is the same."""
    cache, tcache, gt = three_frames
    full = tdt.find_overlapping_pairs(t(gt), torch.ones(3, dtype=torch.bool), tcache, TINTR, TP)
    monkeypatch.setattr(tdt, "_PAIR_CHUNK", 2)
    part = tdt.find_overlapping_pairs(t(gt), torch.ones(3, dtype=torch.bool), tcache, TINTR, TP)
    assert torch.equal(full[0], part[0]) and torch.equal(full[1], part[1])


@pytest.mark.parametrize("w_color", [0.0, 0.1])
def test_dense_system_matches(three_frames, w_color):
    gt = three_frames[2]
    poses = gt.copy()
    poses[1:, 3:] += np.array([[0.01, -0.008, 0.012], [-0.01, 0.012, 0.01]], np.float32)
    poses[1:, :3] += 0.01
    (_, jmask, jsys), (_, _, tsys) = _systems(three_frames, poses, w_color)
    # listed pairs only: the padding entries pair frame 0 with itself, where
    # every pixel projects onto an exact integer and rounding decides
    live = to_np(jmask)
    np.testing.assert_array_equal(tsys.num_corr.numpy()[live], to_np(jsys.num_corr)[live])
    np.testing.assert_array_equal(tsys.mask.numpy(), to_np(jsys.mask))
    assert int(tsys.mask.sum()) >= 2
    Hs, bs = np.abs(to_np(jsys.H)).max(), np.abs(to_np(jsys.b)).max()
    np.testing.assert_allclose(tsys.H.numpy(), to_np(jsys.H), atol=BLOCK_RTOL * Hs)
    np.testing.assert_allclose(tsys.b.numpy(), to_np(jsys.b), atol=BLOCK_RTOL * bs)
    assert torch.isfinite(tsys.H).all() and tsys.b.abs().max() > 0
    x = np.random.default_rng(0).normal(size=(3, 6)).astype(np.float32)
    for name, args in (("dense_matvec", (x,)), ("dense_rhs", ()), ("dense_precond_blocks", ()),
                       ("dense_block_matrix", ())):
        want = to_np(getattr(jdt, name)(jsys, *map(jnp.asarray, args), 3))
        got = getattr(tdt, name)(tsys, *map(t, args), 3).numpy()
        np.testing.assert_allclose(got, want, atol=BLOCK_RTOL * Hs * 10, err_msg=name)


def test_dense_system_zero_residual_at_gt(three_frames):
    _, (_, _, tsys) = _systems(three_frames, three_frames[2])
    assert int(tsys.mask.sum()) >= 2
    b = tdt.dense_rhs(tsys, 3).numpy()
    assert np.abs(b).max() / max(float(tsys.H.abs().max()), 1e-9) < 0.05


def test_dense_matvec_symmetry(three_frames):
    _, (_, _, tsys) = _systems(three_frames, three_frames[2])
    rng = np.random.default_rng(0)
    x = t(rng.normal(size=(3, 6)).astype(np.float32))
    y = t(rng.normal(size=(3, 6)).astype(np.float32))
    Ax, Ay = tdt.dense_matvec(tsys, x, 3), tdt.dense_matvec(tsys, y, 3)
    assert float((y * Ax).sum()) == pytest.approx(float((x * Ay).sum()), rel=1e-3)
    assert float((x * Ax).sum()) >= -1e-5


def test_nan_pixels_do_not_poison_the_jacobian(three_frames):
    _, tcache, gt = three_frames
    assert not torch.isfinite(tcache.campos).all()    # the renders have holes
    zero = np.zeros((3, 6), np.float32)               # so3_exp's small-angle branch
    pairs, mask = tdt.find_overlapping_pairs(t(zero), torch.ones(3, dtype=torch.bool), tcache,
                                             TINTR, TP)
    sys = tdt.build_dense_system(t(zero), pairs, mask, tcache, TINTR, TP, 1.0, 0.1)
    assert torch.isfinite(sys.H).all() and torch.isfinite(sys.b).all()


@pytest.mark.parametrize("linear", ["dense", "pcg"])
def test_solve_bundle_dense_only_recovers_pose(three_frames, linear):
    cache, tcache, gt = three_frames
    init = gt.copy()
    init[1:, 3:] += np.array([[0.01, -0.008, 0.012], [-0.01, 0.012, 0.01]], np.float32)
    kw = dict(num_gn=4, num_pcg=30, linear=linear)
    jout, _ = jgn.solve_bundle(jnp.asarray(init), jnp.ones(3, bool), create_corr_store(64),
                               cache, INTR, jgn.SolverParams(**kw), JP)
    from bundlefusion_tpu_torch.solver.residuals import create_corr_store as tcreate
    tout, tst = tgn.solve_bundle(t(init), torch.ones(3, dtype=torch.bool), tcreate(64, "cpu"),
                                 tcache, TINTR, tgn.SolverParams(**kw), TP)
    err0 = np.abs(init[1:] - gt[1:]).max()
    err1 = np.abs(tout.numpy()[1:] - gt[1:]).max()
    assert err1 < err0 * 0.35, (err0, err1)
    np.testing.assert_allclose(tout.numpy(), to_np(jout), atol=POSE_ATOL)
    assert float(tst.final_cost) == 0.0


@pytest.mark.parametrize("linear", ["dense", "pcg"])
def test_solve_bundle_sparse_and_dense_matches(three_frames, linear):
    """Sparse corrs between the three frames plus the dense term with the
    end-of-run weights (15, colour 0.1)."""
    cache, tcache, gt = three_frames
    rng = np.random.default_rng(4)
    store = create_corr_store(256)
    from bundlefusion_tpu.solver.residuals import append_corrs
    for i, j in ((1, 0), (2, 1), (2, 0)):
        world = rng.uniform(-0.5, 0.5, (20, 3)).astype(np.float32) + [0, 0, 2]
        p_i = world - gt[i, 3:]
        p_j = world - gt[j, 3:]
        store = append_corrs(store, jnp.full((20,), i, jnp.int32), jnp.full((20,), j, jnp.int32),
                             jnp.asarray(p_i, jnp.float32), jnp.asarray(p_j, jnp.float32),
                             jnp.ones(20, bool))
    init = gt.copy()
    init[1:] += rng.normal(size=(2, 6)).astype(np.float32) * 0.01
    kw = dict(num_gn=3, num_pcg=40, linear=linear)
    jout, jst = jgn.solve_bundle(jnp.asarray(init), jnp.ones(3, bool), store, cache, INTR,
                                 jgn.SolverParams(**kw), JP,
                                 dense_weights=jnp.full((3,), 15.0), w_color=0.1)
    tout, tst = tgn.solve_bundle(t(init), torch.ones(3, dtype=torch.bool), port_corrs(store),
                                 tcache, TINTR, tgn.SolverParams(**kw), TP,
                                 dense_weights=[15.0] * 3, w_color=0.1)
    np.testing.assert_allclose(tout.numpy(), to_np(jout), atol=POSE_ATOL)
    np.testing.assert_allclose(float(tst.final_cost), float(jst.final_cost), rtol=1e-2, atol=1e-7)
    assert np.abs(tout.numpy() - gt).max() < np.abs(init - gt).max()
