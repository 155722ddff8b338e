"""The port's frontend orchestration against the JAX package:
``match_and_filter`` (every slot and ``slots=``, store capacity 5 and 160),
``add_to_residuals``, ``chained_sift_transform``, and ``fuse_keyframe`` on
the pattern of ``tests/test_track_fusion.py``. Masks and indices equal,
transforms atol 1e-4, fused positions atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.pipeline import frontend as jfe
from bundlefusion_tpu.solver import residuals as jr
from bundlefusion_tpu_torch.pipeline import frames as tframes
from bundlefusion_tpu_torch.pipeline import frontend as tfe
from bundlefusion_tpu_torch.solver import residuals as tr
from tests import test_track_fusion as jtf
from tests.torch_parity import fields_np, jax_window, port_intr, t, to_np

T_ATOL = 1e-4
POS_ATOL = 1e-4
N_FRAMES = 5


def _params():
    jp = jfe.FrontendParams(dense=jfe.DenseVerifyParams(err_thresh=0.12))
    d = dict(jp.__dict__, dense=tfe.DenseVerifyParams(**jp.dense.__dict__))
    return jp, tfe.FrontendParams(**d)


@pytest.fixture(scope="module", params=[5, 160])
def window(request):
    """Five frames in the first slots of stores with 5 slots (the plain
    path) or 160 (the JAX package's chunked sweep)."""
    keys, cache, intr, intr_cache = jax_window(N_FRAMES, request.param)
    tkeys = tframes.keyframe_store_from_numpy(fields_np(keys), "cpu")
    tcache = tframes.dense_cache_from_numpy(fields_np(cache), "cpu")
    assert tkeys.desc.dtype == torch.bfloat16 and tkeys.capacity == request.param
    return keys, cache, intr, intr_cache, tkeys, tcache


def _assert_mf(got, want):
    pv = to_np(want["pair_valid"])
    np.testing.assert_array_equal(got["pair_valid"].numpy(), pv)
    np.testing.assert_array_equal(got["inlier_mask"].numpy(), to_np(want["inlier_mask"]))
    np.testing.assert_array_equal(got["num_inliers"].numpy(), to_np(want["num_inliers"]))
    np.testing.assert_allclose(got["transforms"].numpy()[pv], to_np(want["transforms"])[pv],
                               rtol=0, atol=T_ATOL)
    inl = to_np(want["inlier_mask"])
    for name in ("idx_cur", "idx_prev", "p_cur", "p_prev"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name].numpy()[inl], to_np(want[name])[inl], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert got["num_keys_per_frame"] == want["num_keys_per_frame"]


@pytest.fixture(scope="module")
def mf_pair(window):
    keys, cache, intr, intr_cache, tkeys, tcache = window
    jp, tp = _params()
    cur = N_FRAMES - 1
    want = jfe.match_and_filter(jnp.asarray(cur), keys, cache, intr, intr_cache, jp)
    got = tfe.match_and_filter(cur, tkeys, tcache, port_intr(intr), port_intr(intr_cache), tp)
    return got, want


def test_match_and_filter(window, mf_pair):
    got, want = mf_pair
    _assert_mf(got, want)
    pv = got["pair_valid"].numpy()
    assert pv[: N_FRAMES - 1].any() and not pv[N_FRAMES - 1:].any()


def test_match_and_filter_slot_zero_has_no_pairs(window):
    *_, intr, intr_cache, tkeys, tcache = window
    got = tfe.match_and_filter(0, tkeys, tcache, port_intr(intr), port_intr(intr_cache),
                               _params()[1])
    assert not got["pair_valid"].any() and not got["inlier_mask"].any()


def test_match_and_filter_explicit_slots(window):
    keys, cache, intr, intr_cache, tkeys, tcache = window
    jp, tp = _params()
    slots = [3, 1, 4]          # out of order; slot 4 is the current frame itself
    want = jfe.match_and_filter(jnp.asarray(4), keys, cache, intr, intr_cache, jp,
                                slots=jnp.asarray(slots))
    got = tfe.match_and_filter(4, tkeys, tcache, port_intr(intr), port_intr(intr_cache), tp,
                               slots=slots)
    assert got["pair_valid"].shape == (3,)
    _assert_mf(got, want)
    assert not bool(got["pair_valid"][2])


def test_add_to_residuals_and_chain(window, mf_pair):
    got, want = mf_pair
    P = got["pair_valid"].shape[0]
    prev = np.arange(P, dtype=np.int32) + 100
    js = jfe.add_to_residuals(jr.create_corr_store(512), want, jnp.asarray(7, jnp.int32),
                              jnp.asarray(prev))
    ts = tfe.add_to_residuals(tr.create_corr_store(512, "cpu"), got, 7, t(prev))
    n = int(ts.count)
    assert n == int(js.count) == int(got["num_inliers"].sum()) > 0
    for name in ("img_i", "img_j", "key_i", "key_j"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), to_np(getattr(js, name)), name)
    for name in ("p_i", "p_j"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), to_np(getattr(js, name)), rtol=0,
                                   atol=1e-6)

    rng = np.random.default_rng(0)
    world = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    world[:, :3, 3] = rng.normal(size=(P, 3))
    T, found, best = tfe.chained_sift_transform(got, t(world))
    jT, jfound, jbest = jfe.chained_sift_transform(want, jnp.asarray(world))
    assert bool(found) and bool(jfound) and int(best) == int(jbest)
    np.testing.assert_allclose(T.numpy(), to_np(jT), rtol=0, atol=T_ATOL)
    none = dict(got, pair_valid=torch.zeros_like(got["pair_valid"]))
    T, found, _ = tfe.chained_sift_transform(none, t(world))
    assert not bool(found) and torch.equal(T, torch.eye(4))


# ---- fuse_keyframe, on the cases of tests/test_track_fusion.py ----


def _fusion_case(two_tracks_one_bad: bool):
    rng = np.random.default_rng(0)
    if two_tracks_one_bad:
        S, K = 2, 8
        world = np.array([[0, 0, 1.0], [0.2, 0, 1.2]], np.float32)
        poses = np.stack([np.eye(4, dtype=np.float32)] * S)
    else:
        S, K = 3, 16
        world = rng.uniform(-0.3, 0.3, (6, 3)).astype(np.float32) + np.float32([0, 0, 1.5])
        # two points at the same depth: the depth sort must break the tie
        world[1, 2] = world[0, 2]
        poses = np.stack([np.eye(4, dtype=np.float32)] * S)
        poses[1][:3, 3] = [0.05, 0, 0]
        poses[2][:3, 3] = [0.10, 0, 0]
    M = world.shape[0]
    poses_inv = np.stack([np.linalg.inv(p) for p in poses])
    store = jtf._make_store(S, K, world, poses_inv)
    corrs = jr.create_corr_store(64)
    for s in range(1, S):
        p_i = world @ poses_inv[s][:3, :3].T + poses_inv[s][:3, 3]
        p_j = world @ poses_inv[s - 1][:3, :3].T + poses_inv[s - 1][:3, 3]
        if two_tracks_one_bad:
            p_i[1] += [0.5, 0, 0]           # 0.5 m apart: joins, contributes nothing
        corrs = jr.append_corrs(
            corrs, jnp.full((M,), s, jnp.int32), jnp.full((M,), s - 1, jnp.int32),
            jnp.asarray(p_i.astype(np.float32)), jnp.asarray(p_j.astype(np.float32)),
            jnp.ones((M,), bool), jnp.asarray(s * K + np.arange(M), jnp.int32),
            jnp.asarray((s - 1) * K + np.arange(M), jnp.int32))
    return store, corrs, poses, M


@pytest.mark.parametrize("bad_track,max_out", [(False, 32), (False, 4), (True, 16), (False, 64)])
def test_fuse_keyframe(bad_track, max_out):
    store, corrs, poses, M = _fusion_case(bad_track)
    want = jfe.fuse_keyframe(store, corrs, jnp.asarray(poses), 0, jtf.INTR, max_out_keys=max_out)
    got = tfe.fuse_keyframe(
        tframes.keyframe_store_from_numpy(fields_np(store), "cpu"),
        tr.corr_store_from_numpy(fields_np(corrs), "cpu"), t(poses), 0, port_intr(jtf.INTR),
        max_out_keys=max_out)
    v = to_np(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    assert v.sum() == (1 if bad_track else min(M, max_out))
    for name in ("pos", "depth", "response", "scale", "desc"):
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name].to(torch.float32).numpy()[v],
                                   to_np(want[name])[v], rtol=0, atol=POS_ATOL, err_msg=name)
