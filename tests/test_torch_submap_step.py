"""One submap boundary of the port against the JAX engine's ``submap_step``.

The JAX engine (module-scoped, the small configuration with
``submap_size=4``) is driven frame by frame through its own ``_frame_step``;
just before each boundary its device state is copied out as numpy and
carried into a port engine by ``local_state_from_numpy`` /
``global_state_from_numpy``; then both run the boundary on the same state:
g = 0 (no global branch) and g = 1 (global match, global solve, and, with a
bogus pair injected into the global store, a prune round).

The packs agree: flags and validity equal, chained and composed poses within
``POSE_ATOL`` (float32 solves whose sums differ in order). Also: global
matching over a keyframe store above 128 slots, where the JAX package sweeps
in chunks with an early exit and the port selects the live slots, with the
live slots on both sides of a chunk's edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.pipeline import frames as jframes
from bundlefusion_tpu.pipeline import frontend as jfe
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
from bundlefusion_tpu.solver.residuals import append_corrs as jappend
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.pipeline import frames as tframes
from bundlefusion_tpu_torch.pipeline import frontend as tfe
from bundlefusion_tpu_torch.pipeline.online import (
    BundleFusion as TorchEngine,
    global_state_from_numpy,
    local_state_from_numpy,
)
from tests.torch_parity import APP, BUNDLING, SIFT, fields_np, jax_window, port_intr, to_np

POSE_ATOL = 2e-3
BUND = dict(BUNDLING, submap_size=4)
G = 8


def _state_np(jeng):
    loc, glob = jeng.local, jeng.glob
    return {
        "local": {"keys": fields_np(loc.keys), "cache": fields_np(loc.cache),
                  "corrs": fields_np(loc.corrs), "rel": to_np(loc.rel),
                  "valid": to_np(loc.valid)},
        "glob": {"keys": fields_np(glob.keys), "cache": fields_np(glob.cache),
                 "corrs": fields_np(glob.corrs), "poses": to_np(glob.poses),
                 "local_traj": to_np(glob.local_traj), "local_valid": to_np(glob.local_valid)},
        "kf_valid": to_np(jeng.kf_valid_dev),
        "submap_base": to_np(jeng.submap_base),
    }


def _port_boundary(state, g, last_world, **bund):
    intr = default_intrinsics(160, 120)
    eng = TorchEngine(port_intr(intr), port.AppConfig(**APP),
                      port.BundlingConfig(**dict(BUND, **bund)),
                      sift_cfg=port.SiftConfig(**SIFT), max_keyframes=G, device="cpu")
    eng.local = local_state_from_numpy(state["local"], "cpu")
    eng.glob = global_state_from_numpy(state["glob"], "cpu")
    eng.kf_valid_dev = torch.from_numpy(state["kf_valid"].copy())
    eng.submap_base = torch.from_numpy(state["submap_base"].copy())
    pack = eng._submap_step(g, torch.from_numpy(np.array(last_world)))
    return eng, pack.numpy()


@pytest.fixture(scope="module")
def boundaries():
    """[(g, state before, JAX pack, JAX engine's glob poses / kf_valid after,
    last_world)] for g = 0 and g = 1; a bogus (kf1, kf0) pair is injected
    into the global store before the second boundary."""
    intr = default_intrinsics(160, 120)
    seq = make_sequence(9, intr=intr)
    jeng = JaxEngine(intr, AppConfig(**APP), BundlingConfig(**BUND),
                     sift_cfg=SiftConfig(**SIFT), max_keyframes=G)
    out = []
    for f in range(9):
        slot = f % 4
        boundary = f > 0 and slot == 0
        cur = 4 if boundary else slot
        d_u16, c_u8 = JaxEngine._to_wire(seq["depth"][f], seq["color"][f])
        jeng.local, jeng.store, T_world, _ = jeng._frame_step(
            jnp.asarray(d_u16), jnp.asarray(c_u8), jeng.local, jeng.store, jeng.submap_base,
            jnp.asarray(cur, jnp.int32), jnp.asarray(f, jnp.int32))
        if not boundary:
            continue
        g = jeng.num_keyframes
        if g == 1:
            rng = np.random.default_rng(0)
            p_i = rng.uniform(-0.5, 0.5, (8, 3)).astype(np.float32) + np.float32([0, 0, 1.5])
            bad = jappend(jeng.glob.corrs, jnp.full((8,), 1, jnp.int32),
                          jnp.zeros((8,), jnp.int32), jnp.asarray(p_i),
                          jnp.asarray(p_i + np.float32([0.5, 0.3, 0.0])), jnp.ones((8,), bool))
            jeng.glob = jeng.glob._replace(corrs=bad)
        state = _state_np(jeng)
        last_world = to_np(T_world)
        jeng.local, jeng.glob, jeng.kf_valid_dev, overlap, pack = jeng._submap_step(
            jeng.local, jeng.glob, jeng.kf_valid_dev, jnp.asarray(g, jnp.int32),
            jeng.submap_base, T_world)
        jeng.submap_base = overlap
        jeng.num_keyframes += 1
        out.append({"g": g, "state": state, "pack": to_np(pack), "last_world": last_world,
                    "overlap": to_np(overlap), "corrs_after": fields_np(jeng.glob.corrs),
                    "local_after": fields_np(jeng.local.keys), "offsets": (
                        jeng._off_lv, jeng._off_kf, jeng._off_flags, jeng._off_comp,
                        jeng._off_ok)})
    return out


@pytest.mark.parametrize("which", [0, 1])
def test_boundary_pack_matches(boundaries, which):
    b = boundaries[which]
    eng, pack = _port_boundary(b["state"], b["g"], b["last_world"])
    off_lv, off_kf, off_flags, off_comp, off_ok = b["offsets"]
    assert (eng._off_lv, eng._off_kf, eng._off_flags, eng._off_comp, eng._off_ok) == b["offsets"]
    want = b["pack"]
    assert pack.shape == want.shape
    # chained world poses, frame validity, keyframe validity, the three flags
    np.testing.assert_allclose(pack[:off_lv], want[:off_lv], atol=1e-5)
    np.testing.assert_array_equal(pack[off_lv:off_comp], want[off_lv:off_comp])
    assert pack[off_flags] == 1.0 and pack[off_flags + 1] == 1.0 and pack[off_flags + 2] == 0.0
    # the composed trajectory: the same frames valid, poses close
    np.testing.assert_array_equal(pack[off_ok:], want[off_ok:])
    ok = np.repeat(want[off_ok:] > 0.5, 16)
    # (keyframe 1 loses its support to the prune round: only submap 0 composes)
    assert ok.sum() == 16 * 4
    np.testing.assert_allclose(pack[off_comp:off_ok][ok], want[off_comp:off_ok][ok],
                               atol=POSE_ATOL)
    assert np.isnan(pack[off_comp:off_ok][~ok]).all()
    # the next window's base, and the rollover
    np.testing.assert_allclose(eng.submap_base.numpy(), b["overlap"], atol=POSE_ATOL)
    np.testing.assert_allclose(eng.local.keys.pos[0].numpy(), b["local_after"]["pos"][0])
    assert bool(eng.local.valid[0]) and int(eng.local.corrs.count) == 0
    assert eng.boundary_stats[-1]["g"] == b["g"]


def test_first_boundary_has_no_global_branch(boundaries):
    b = boundaries[0]
    eng, _ = _port_boundary(b["state"], 0, b["last_world"])
    assert int(eng.glob.corrs.count) == 0
    assert eng.boundary_stats[-1]["prune_rounds"] == 0
    assert bool(eng.kf_valid_dev[0]) and not bool(eng.kf_valid_dev[1:].any())
    assert "time_submap_global_solve" not in eng.timing.totals()
    # the fused keyframe sits in row 0 of the global stores
    assert int(eng.glob.keys.valid[0].sum()) > 10 and bool(eng.glob.keys.frame_valid[0])
    np.testing.assert_array_equal(eng.glob.cache.depth[0].numpy(),
                                  b["state"]["local"]["cache"]["depth"][0])


def test_second_boundary_prunes_the_injected_pair(boundaries):
    b = boundaries[1]
    eng, _ = _port_boundary(b["state"], 1, b["last_world"])
    assert eng.boundary_stats[-1]["prune_rounds"] == 1
    # the whole (1, 0) pair is gone from the store on both sides: the
    # injected corrs and the clean ones this boundary appended
    np.testing.assert_array_equal(eng.glob.corrs.img_i.numpy(), b["corrs_after"]["img_i"])
    assert int(eng.glob.corrs.count) > 8 and not bool(eng.glob.corrs.valid_mask().any())
    # comprehensive invalidation: keyframe 1 is left without support
    assert bool(eng.kf_valid_dev[0]) and not bool(eng.kf_valid_dev[1])


@pytest.mark.parametrize("bund", [dict(use_local_dense=False), dict(use_local_verify=False),
                                  dict(use_guided_remove=True, max_prune_rounds=1)],
                         ids=["sparse_local", "no_verify", "guided_one_round"])
def test_boundary_options(boundaries, bund):
    """The boundary's switches: a sparse-only local solve, no verification,
    guided removal with one round. Still all frames valid and a composed
    trajectory close to the default's."""
    b = boundaries[1]
    eng, pack = _port_boundary(b["state"], 1, b["last_world"], **bund)
    off_lv, off_kf, off_flags, off_comp, off_ok = b["offsets"]
    np.testing.assert_array_equal(pack[off_lv:off_kf], b["pack"][off_lv:off_kf])
    assert pack[off_flags] == 1.0
    ok = np.repeat(pack[off_ok:] > 0.5, 16)
    assert ok.sum() >= 16 * 4
    both = ok & np.repeat(b["pack"][off_ok:] > 0.5, 16)
    np.testing.assert_allclose(pack[off_comp:off_ok][both], b["pack"][off_comp:off_ok][both],
                               atol=0.02)


def test_global_matching_above_128_slots():
    """Six keyframes in slots 125..130 of a 136-slot store: the JAX package
    sweeps two chunks of 128 (the second ends early), the port gathers the
    live slots. Same pairs, same inliers."""
    n, cap, first = 6, 136, 125
    keys, cache, intr, intr_cache = jax_window(n, cap)

    def shift(a):
        a = np.array(a)
        out = np.zeros_like(a) if a.dtype != np.float32 else np.full_like(a, a[-1])
        out[first:first + n] = a[:n]
        return out

    knp = {k: shift(v) for k, v in fields_np(keys).items()}
    cnp = {k: shift(v) for k, v in fields_np(cache).items()}
    jkeys = jframes.KeyframeStore(**{k: jnp.asarray(v, dtype=getattr(keys, k).dtype)
                                     for k, v in knp.items()})
    jcache = jframes.DenseCache(**{k: jnp.asarray(v) for k, v in cnp.items()})
    tkeys = tframes.keyframe_store_from_numpy(knp, "cpu")
    tcache = tframes.dense_cache_from_numpy(cnp, "cpu")
    jp = jfe.FrontendParams(min_num_matches=4, dense=jfe.DenseVerifyParams(err_thresh=0.12))
    tp = tfe.FrontendParams(min_num_matches=4, dense=tfe.DenseVerifyParams(err_thresh=0.12))
    cur = first + n - 1
    want = jfe.match_and_filter(jnp.asarray(cur), jkeys, jcache, intr, intr_cache, jp)
    got = tfe.match_and_filter(cur, tkeys, tcache, port_intr(intr), port_intr(intr_cache), tp)
    pv = to_np(want["pair_valid"])
    assert pv.shape == (cap,) and pv[first:cur].sum() >= 2 and not pv[:first].any()
    assert pv[first:128].any() and pv[128:cur].any()      # both sides of the chunk's edge
    np.testing.assert_array_equal(got["pair_valid"].numpy(), pv)
    np.testing.assert_array_equal(got["num_inliers"].numpy(), to_np(want["num_inliers"]))
    np.testing.assert_array_equal(got["inlier_mask"].numpy(), to_np(want["inlier_mask"]))
    np.testing.assert_allclose(got["transforms"].numpy()[pv], to_np(want["transforms"])[pv],
                               atol=1e-4)
