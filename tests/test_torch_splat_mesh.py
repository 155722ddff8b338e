"""Port splat render, mesh extraction and PLY export against JAX.

Both sides read the same table: the one from the apply test's setup
(``tests/test_apply_pallas.py``: 3 synthetic frames at 80x60, 4 cm voxels),
allocated and fused by the JAX package and copied into the port's
``VoxelBlockTable``, so the comparison holds these modules alone.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.io import ply as jply
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.tsdf import apply_pallas as japply
from bundlefusion_tpu.tsdf import integrate as jint
from bundlefusion_tpu.tsdf import marching_cubes as jmc
from bundlefusion_tpu.tsdf import splat as jsplat
from bundlefusion_tpu.tsdf import table as jtab
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.io import ply as tply
from bundlefusion_tpu_torch.tsdf import integrate as tint
from bundlefusion_tpu_torch.tsdf import marching_cubes as tmc
from bundlefusion_tpu_torch.tsdf import splat as tsplat
from bundlefusion_tpu_torch.tsdf import table as ttab

INTR_IN = default_intrinsics(160, 120)
INTR = INTR_IN.scaled(80, 60)
TINTR = CameraIntrinsics(**INTR.__dict__)
PARAMS = jint.TsdfParams(voxel_size=0.04, truncation=0.12, max_integration_distance=4.0)
TPARAMS = tint.TsdfParams(**PARAMS.__dict__)
# Same table, same arithmetic in another order (XLA:CPU fuses and contracts
# the projection into FMAs): one or two float32 roundings apart. Normals
# are cross products of neighbour differences, normalised: a few ulps of
# the points become ~1e-6 there. Mesh vertices interpolate along 4 cm
# edges at coordinates up to ~3 m.
ATOL_IMG = 1e-6
ATOL_NORMAL = 1e-5
ATOL_MESH = 1e-5


def _to_port(jt) -> ttab.VoxelBlockTable:
    arrays = {}
    for f in dataclasses.fields(ttab.VoxelBlockTable):
        a = np.array(getattr(jt, f.name))
        if f.name == "slot_geo":
            a = np.ascontiguousarray(a[:, : ttab.SLOT_GEO_LANES])
        arrays[f.name] = torch.from_numpy(a)
    return ttab.VoxelBlockTable(**arrays)


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
    return jt, _to_port(jt), P


@pytest.mark.parametrize("frame,shift", [(0, 0.0), (2, 0.0), (1, 0.05)])
@pytest.mark.parametrize("variant", [
    {}, {"visible_cap": 64}, {"use_color": False}, {"fill_passes": 0},
])
def test_splat_render_matches(tables, frame, shift, variant):
    jt, tt, P = tables
    pose = P[frame].copy()
    pose[0, 3] += shift
    jr = jsplat.splat_render(jt, INTR, jnp.asarray(pose), PARAMS,
                             jsplat.SplatParams(**variant))
    tr = tsplat.splat_render(tt, TINTR, torch.from_numpy(pose), TPARAMS,
                             tsplat.SplatParams(**variant))
    assert int(np.isfinite(np.asarray(jr["depth"])).sum()) > 500
    for name, atol in (("depth", ATOL_IMG), ("points", ATOL_IMG),
                       ("normals", ATOL_NORMAL), ("color", ATOL_IMG)):
        a, b = np.asarray(jr[name]), tr[name].numpy()
        assert b.shape == a.shape and b.dtype == np.float32, name
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=name)
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, equal_nan=True, err_msg=name)


def _look_at(eye, target, up):
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, np.cross(z, x), z, eye
    return T


# view directions whose largest component is x, y and z (and the negative
# x and y), each from 1.5 m in front of the fused surface's centre
VIEWS = {"x": ((0.8, 0.1, 0.55), (0, -1, 0)), "y": ((0.1, 0.85, 0.5), (0, 0, -1)),
         "z": ((0.0, 0.0, 1.0), (0, -1, 0)), "-x": ((-0.8, 0.1, 0.55), (0, -1, 0)),
         "-y": ((0.1, -0.85, 0.5), (0, 0, -1))}


@pytest.mark.parametrize("view", list(VIEWS))
def test_splat_walk_axis_chosen_on_the_device_matches(tables, view):
    """The render picks the walk along the dominant view axis by a device
    gather (the reference's ``lax.switch``; no read of the axis on the
    host): for views dominated by x, y and z it matches the JAX render
    within the file's limits."""
    jt, tt, _ = tables
    geo = tt.slot_geo[tt.slot_geo[:, 3] > 0.5][:, :3].numpy()
    centre = (geo.mean(0) + 0.5) * 8 * PARAMS.voxel_size
    d, up = VIEWS[view]
    d = np.asarray(d) / np.linalg.norm(d)
    pose = _look_at(centre - 1.5 * d, centre, up)
    assert int(np.argmax(np.abs(pose[:3, 2]))) == "xyz".index(view[-1])
    jr = jsplat.splat_render(jt, INTR, jnp.asarray(pose), PARAMS)
    tr = tsplat.splat_render(tt, TINTR, torch.from_numpy(pose), TPARAMS)
    assert int(np.isfinite(np.asarray(jr["depth"])).sum()) > 500
    for name, atol in (("depth", ATOL_IMG), ("points", ATOL_IMG),
                       ("normals", ATOL_NORMAL), ("color", ATOL_IMG)):
        a, b = np.asarray(jr[name]), tr[name].numpy()
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a), err_msg=name)
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, equal_nan=True, err_msg=name)


def test_gathered_walks_are_the_reshapes():
    """Each row of ``walk_orders``, gathered, lays a block out bit for bit
    as the walk's reshape does."""
    a = torch.from_numpy(np.random.default_rng(0).normal(size=(7, 512)).astype(np.float32))
    orders = tsplat.walk_orders("cpu")
    for axis, walk in enumerate((tsplat._walk_x, tsplat._walk_y, tsplat._walk_z)):
        got = tsplat._gathered_walk(orders[axis])(a)
        assert torch.equal(got.view(torch.int32), walk(a).view(torch.int32)), axis


def test_extract_mesh_matches(tables):
    jt, tt, _ = tables
    jv, jc = jmc.extract_mesh(jt, PARAMS.voxel_size)
    tv, tc = tmc.extract_mesh(tt, TPARAMS.voxel_size)
    assert jv.shape[0] > 1000
    assert tv.shape == jv.shape and tc.shape == jc.shape
    assert tv.dtype == np.float32 and tc.dtype == np.float32
    np.testing.assert_allclose(tv, jv, rtol=0, atol=ATOL_MESH)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=ATOL_MESH)


def test_extract_mesh_empty_table():
    v, c = tmc.extract_mesh(ttab.create_table(256, 128, "cpu"), 0.01)
    assert v.shape == (0, 3, 3) and c.shape == (0, 3, 3)


@pytest.mark.parametrize("with_color", [True, False])
def test_save_ply_matches(tables, tmp_path, with_color):
    _, tt, _ = tables
    v, c = tmc.extract_mesh(tt, TPARAMS.voxel_size)
    colors = c if with_color else None
    jply.save_ply(str(tmp_path / "jax.ply"), v, colors)
    tply.save_ply(str(tmp_path / "port.ply"), v, colors)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    assert tply.load_ply_vertex_count(str(tmp_path / "port.ply")) == 3 * v.shape[0]
