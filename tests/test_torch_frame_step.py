"""The slice as a whole: ``frame_step`` of the port against the JAX engine.

Both engines at the small configuration with ``submap_size=8`` (a window of
nine slots, so nine frames fit with no boundary), the port on the CPU; nine
frames of ``make_sequence(9)`` through ``_frame_step`` on both sides.
``valid`` equal on every frame; ``T_world`` within 2e-3 in translation and
2e-3 rad in rotation; the count of live correspondences within 5 %. Then the
port's own chain goes on to ``_tsdf_dispatch`` and ``_render_frame`` with
its own poses: table invariants clean, no allocation failure. And a frame
with all-NaN depth is invalid on both sides while later frames recover.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.pipeline.online import (
    BundleFusion as TorchEngine,
    local_state_from_numpy,
)
from bundlefusion_tpu_torch.tsdf.table import check_invariants
from tests.torch_parity import APP, BUNDLING, SIFT, fields_np, port_intr, to_np

N = 9
TRANS_TOL = 2e-3
ROT_TOL = 2e-3     # radians
CORR_RTOL = 0.05


def _engines():
    intr = default_intrinsics(160, 120)
    bund = dict(BUNDLING, submap_size=8)
    jeng = JaxEngine(intr, AppConfig(**APP), BundlingConfig(**bund),
                     sift_cfg=SiftConfig(**SIFT), max_keyframes=8)
    teng = TorchEngine(port_intr(intr), port.AppConfig(**APP), port.BundlingConfig(**bund),
                       sift_cfg=port.SiftConfig(**SIFT), max_keyframes=8, device="cpu")
    assert teng.S == jeng.S == N
    return jeng, teng


def _run(seq, with_fusion: bool):
    """Nine frames through both engines: per frame (jax T, jax valid, port
    T, port valid), then the engines."""
    jeng, teng = _engines()
    out = []
    for f in range(N):
        d_u16, c_u8 = JaxEngine._to_wire(seq["depth"][f], seq["color"][f])
        jeng.local, jeng.store, jT, jv = jeng._frame_step(
            jnp.asarray(d_u16), jnp.asarray(c_u8), jeng.local, jeng.store, jeng.submap_base,
            jnp.asarray(f, jnp.int32), jnp.asarray(f, jnp.int32))
        tT, tv = teng._frame_step(d_u16, c_u8, f, teng._store_slot(f))
        assert isinstance(tT, torch.Tensor) and tT.shape == (4, 4) and tv.dtype == torch.bool
        T_host, v_host = tT.numpy().copy(), bool(tv)
        if with_fusion:
            # the fusion takes the step's device pose and validity as they are
            teng._tsdf_dispatch(teng._store_slot(f), tT, tv)
            teng._record_frame(f, T_host, v_host)
            teng._render_frame(f, tT)
        out.append((to_np(jT), bool(jv), T_host, v_host))
    return out, jeng, teng


def _assert_poses_close(frames):
    for f, (jT, jv, tT, tv) in enumerate(frames):
        assert tv == jv, f
        dt = np.linalg.norm(tT[:3, 3] - jT[:3, 3])
        dR = tT[:3, :3].T @ jT[:3, :3]
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert dt < TRANS_TOL and ang < ROT_TOL, (f, dt, ang)


@pytest.fixture(scope="module")
def clean_run():
    seq = make_sequence(N, intr=default_intrinsics(160, 120))
    return _run(seq, with_fusion=True) + (seq,)


def test_valid_and_poses_match(clean_run):
    frames = clean_run[0]
    assert all(v for _, v, _, _ in frames)
    _assert_poses_close(frames)
    # the chain moved: the last pose is no identity
    assert np.linalg.norm(frames[-1][2][:3, 3]) > 0.05


def test_local_state_matches(clean_run):
    _, jeng, teng, _ = clean_run
    n_j = int(jeng.local.corrs.valid_mask().sum())
    n_t = int(teng.local.corrs.valid_mask().sum())
    assert n_t > 100 and abs(n_t - n_j) <= CORR_RTOL * n_j, (n_t, n_j)
    assert int(teng.local.corrs.count) == n_t
    np.testing.assert_array_equal(teng.local.valid.numpy(), to_np(jeng.local.valid))
    np.testing.assert_allclose(teng.local.rel.numpy(), to_np(jeng.local.rel), rtol=0,
                               atol=TRANS_TOL)
    # the archive agrees (colour within one code, as in the fusion test)
    np.testing.assert_array_equal(to_np(jeng.store.depth_mm)[:N],
                                  teng.store.depth_mm.to(torch.int32).numpy()[:N])
    # the numpy constructors carry the JAX window into the port unchanged
    loc = local_state_from_numpy(
        {"keys": fields_np(jeng.local.keys), "cache": fields_np(jeng.local.cache),
         "corrs": fields_np(jeng.local.corrs), "rel": to_np(jeng.local.rel),
         "valid": to_np(jeng.local.valid)}, "cpu")
    assert loc.keys.desc.dtype == torch.bfloat16
    np.testing.assert_array_equal(loc.keys.desc.to(torch.float32).numpy(),
                                  to_np(jeng.local.keys.desc))
    np.testing.assert_array_equal(loc.cache.depth.numpy(), to_np(jeng.local.cache.depth))
    assert int(loc.corrs.count) == int(jeng.local.corrs.count)


def test_fusion_on_own_poses(clean_run):
    _, _, teng, seq = clean_run
    inv = check_invariants(teng.table)
    assert all(v == 0 for v in inv.values()), inv
    assert int(teng.table.num_alloc_failures) == 0
    assert teng.frame_valid == [True] * N and len(teng.trajectory()) == N
    d = teng.last_render["depth"].numpy()
    gt = seq["depth"][N - 1][::2, ::2]
    both = np.isfinite(d) & np.isfinite(gt)
    assert both.sum() > 1000
    assert np.median(np.abs(d[both] - gt[both])) < 2 * teng.tsdf_params.voxel_size
    stages = teng.timing.totals()
    assert {"time_sift_pyramid", "time_sift_matching", "time_match_filter_key_point"} <= set(stages)


def test_rollover_local(clean_run):
    _, _, teng, _ = clean_run
    old = teng.local
    last_pos = old.keys.pos[N - 1].clone()
    last_depth = old.cache.depth[N - 1].clone()
    teng._rollover_local()
    new = teng.local
    assert new is not old
    assert torch.equal(new.keys.pos[0], last_pos)
    assert torch.equal(new.keys.frame_valid[0], old.keys.frame_valid[N - 1])
    np.testing.assert_array_equal(new.cache.depth[0].numpy(), last_depth.numpy())
    assert bool(new.valid[0]) and not bool(new.valid[1:].any())
    assert not bool(new.keys.valid[1:].any()) and int(new.corrs.count) == 0
    assert torch.equal(new.rel, torch.eye(4).repeat(N, 1, 1))
    teng.local = old


def test_nan_depth_frame_is_invalid_then_recovers():
    seq = make_sequence(N, intr=default_intrinsics(160, 120))
    seq["depth"][4][:] = np.nan
    frames, _, teng = _run(seq, with_fusion=False)
    valid = [v for _, v, _, _ in frames]
    assert valid == [True] * 4 + [False] + [True] * 4
    _assert_poses_close(frames)
    # the lost frame holds the previous pose
    np.testing.assert_array_equal(frames[4][2], frames[3][2])
    assert not bool(teng.local.keys.frame_valid[4])
