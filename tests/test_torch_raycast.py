"""The port's raycast renderer (``tsdf/raycast.py``) and ``BundleFusion.render``
against the JAX package's ``raycast``.

Both sides read the same table: 3 synthetic frames at 80x60 with 4 cm
voxels (the setup of ``tests/test_torch_splat_mesh.py``), allocated and fused
by the JAX package and carried into the port with ``table_from_numpy``, so
the comparison holds the renderer alone. The local block grid is equal
exactly. The march and the bisection are the same float32 arithmetic in
another order (XLA:CPU contracts products into FMAs), so a ray whose sample
sits within an ulp of a voxel edge or of a zero crossing may hit in one
package and not the other: such pixels are at most 0.1 % of the image.
Where both hit, depth agrees within 1e-5 m, colour and normals within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.tsdf import apply_pallas as japply
from bundlefusion_tpu.tsdf import integrate as jint
from bundlefusion_tpu.tsdf import raycast as jray
from bundlefusion_tpu.tsdf import table as jtab
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.pipeline.online import BundleFusion
from bundlefusion_tpu_torch.tsdf import integrate as tint
from bundlefusion_tpu_torch.tsdf import raycast as tray
from bundlefusion_tpu_torch.tsdf import table as ttab
from tests.torch_parity import APP, BUNDLING, SIFT, fields_np

INTR_IN = default_intrinsics(160, 120)
INTR = INTR_IN.scaled(80, 60)
TINTR = CameraIntrinsics(**INTR.__dict__)
PARAMS = jint.TsdfParams(voxel_size=0.04, truncation=0.12, max_integration_distance=4.0)
TPARAMS = tint.TsdfParams(**PARAMS.__dict__)
ATOL_DEPTH = 1e-5
ATOL_IMG = 1e-5
MAX_EDGE_SHARE = 1e-3


@pytest.fixture(scope="module")
def tables():
    seq = make_sequence(3, intr=INTR_IN)
    D = np.ascontiguousarray(seq["depth"][:, ::2, ::2])
    C = np.ascontiguousarray(seq["color"][:, ::2, ::2])
    P = seq["poses"].astype(np.float32)
    jt = jtab.create_table(4096, 2048)
    for i in range(3):
        jt = jint.allocate_for_frame(jt, jnp.asarray(D[i]), INTR, jnp.asarray(P[i]), PARAMS)
    jt = japply.apply_tsdf_ops_xla(
        jt, jnp.asarray(D), jnp.asarray(C), jnp.asarray(P),
        jnp.ones((3,), jnp.float32), jnp.arange(3, dtype=jnp.int32), INTR, PARAMS,
    )
    return jt, ttab.table_from_numpy(fields_np(jt), "cpu"), P


def _compare(jr, tr):
    jd, td = np.asarray(jr["depth"]), tr["depth"].numpy()
    jhit, thit = np.isfinite(jd), np.isfinite(td)
    assert jhit.sum() > 0.3 * jd.size, jhit.sum()
    assert (jhit != thit).mean() <= MAX_EDGE_SHARE, int((jhit != thit).sum())
    both = jhit & thit
    np.testing.assert_allclose(td[both], jd[both], atol=ATOL_DEPTH, rtol=0)
    for key in ("color", "points"):
        np.testing.assert_allclose(tr[key].numpy()[both], np.asarray(jr[key])[both],
                                   atol=ATOL_IMG, rtol=0, err_msg=key)
    jn, tn = np.asarray(jr["normals"]), tr["normals"].numpy()
    nboth = np.isfinite(jn).all(-1) & np.isfinite(tn).all(-1)
    assert nboth.sum() > 0.9 * (np.isfinite(jn).all(-1)).sum()
    np.testing.assert_allclose(tn[nboth], jn[nboth], atol=ATOL_IMG, rtol=0)
    for key in ("depth", "points", "normals", "color"):
        assert tr[key].shape == tuple(np.asarray(jr[key]).shape), key


@pytest.mark.parametrize("frame,shift", [(0, 0.0), (2, 0.0), (1, 0.05)])
@pytest.mark.parametrize("variant", [{}, {"use_color": False, "refine_iters": 3},
                                     {"grid_dim": 24}])
def test_raycast_matches(tables, frame, shift, variant):
    jt, tt, P = tables
    pose = P[frame].copy()
    pose[0, 3] += shift
    jr = jray.raycast(jt, INTR, jnp.asarray(pose), PARAMS, jray.RaycastParams(**variant))
    tr = tray.raycast(tt, TINTR, torch.from_numpy(pose), TPARAMS, tray.RaycastParams(**variant))
    _compare(jr, tr)
    if variant.get("use_color") is False:
        assert torch.isnan(tr["color"]).all()


@pytest.mark.parametrize("grid_dim", [16, 90])
def test_build_local_grid_equal(tables, grid_dim):
    jt, tt, P = tables
    center = P[1][:3, 3] + P[1][:3, 2] * 2.05
    jg, jo = jray.build_local_grid(jt, jnp.asarray(center), PARAMS.voxel_size, grid_dim)
    tg, to = tray.build_local_grid(tt, torch.from_numpy(center), TPARAMS.voxel_size, grid_dim)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert (tg >= 0).sum() > 0


def test_auto_grid_dim_matches_the_reference():
    """At ``AppConfig()`` defaults (320x240 integration, 1 cm voxels) the
    grid is about 90 blocks per axis, as the reference sizes it."""
    intr = CameraIntrinsics(**default_intrinsics(640, 480).scaled(320, 240).__dict__)
    params = tint.TsdfParams(voxel_size=0.01, truncation=0.06)
    d = tray.auto_grid_dim(intr, params, tray.RaycastParams())
    assert 80 <= d <= 100 and d % 2 == 0, d
    assert tray.auto_grid_dim(intr, params, tray.RaycastParams(grid_dim=64)) == 64


def test_engine_render_matches_reference_raycast(tables):
    """``BundleFusion.render`` is the raycast at integration resolution with
    the app's step factor and render depth range, as the JAX engine's."""
    jt, _, P = tables
    app = port.AppConfig(**dict(APP, sdf_voxel_size=0.04, sdf_truncation=0.12,
                                sdf_max_integration_distance=4.0))
    eng = BundleFusion(CameraIntrinsics(**INTR_IN.__dict__), app,
                       port.BundlingConfig(**BUNDLING), sift_cfg=port.SiftConfig(**SIFT),
                       max_keyframes=4, device="cpu")
    eng.table = ttab.table_from_numpy(fields_np(jt), "cpu")
    assert eng.intr_int.__dict__ == TINTR.__dict__
    rp = jray.RaycastParams(ray_increment_factor=app.sdf_ray_increment_factor,
                            depth_min=app.render_depth_min, depth_max=app.render_depth_max)
    jparams = jint.TsdfParams(**dataclasses.asdict(eng.tsdf_params))
    jr = jray.raycast(jt, INTR, jnp.asarray(P[2]), jparams, rp)
    tr = eng.render(P[2])
    _compare(jr, tr)
