"""Port TSDF allocation helpers, visible-block compaction, weight decay and
the integrate / de-integrate entry points against the JAX package.

Setup of ``tests/test_apply_pallas.py`` (3 synthetic frames at 80x60, 4 cm
voxels). Candidate blocks and visible positions are integer results of the
same float32 arithmetic and must be equal; the payload limits are the apply
test's (weight exact, sdf / colour within 1e-6).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.tsdf import apply_pallas as japply
from bundlefusion_tpu.tsdf import integrate as jint
from bundlefusion_tpu.tsdf import table as jtab
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.tsdf import integrate as tint
from bundlefusion_tpu_torch.tsdf import table as ttab

INTR_IN = default_intrinsics(160, 120)
INTR = INTR_IN.scaled(80, 60)
TINTR = CameraIntrinsics(**INTR.__dict__)
PARAMS = jint.TsdfParams(voxel_size=0.04, truncation=0.12, max_integration_distance=4.0)
TPARAMS = tint.TsdfParams(**PARAMS.__dict__)
ATOL = 1e-6


@pytest.fixture(scope="module")
def frames():
    seq = make_sequence(3, intr=INTR_IN)
    D = np.ascontiguousarray(seq["depth"][:, ::2, ::2])
    C = np.ascontiguousarray(seq["color"][:, ::2, ::2])
    return D, C, seq["poses"].astype(np.float32)


def _tables(D, P):
    jt, tt = jtab.create_table(4096, 2048), ttab.create_table(4096, 2048, "cpu")
    for i in range(D.shape[0]):
        jt = jint.allocate_for_frame(jt, jnp.asarray(D[i]), INTR, jnp.asarray(P[i]), PARAMS)
        tint.allocate_for_frame(tt, torch.from_numpy(D[i]), TINTR, torch.from_numpy(P[i]),
                                TPARAMS)
    return jt, tt


@pytest.mark.parametrize("i", range(3))
def test_candidate_blocks_match(frames, i):
    D, _, P = frames
    jc, jm = jint.candidate_blocks(jnp.asarray(D[i]), INTR, jnp.asarray(P[i]), PARAMS)
    tc, tm = tint.candidate_blocks(torch.from_numpy(D[i]), TINTR, torch.from_numpy(P[i]),
                                   TPARAMS)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    m = tm.numpy()
    assert m.sum() > 100
    np.testing.assert_array_equal(np.asarray(jc)[m], tc.numpy()[m])
    np.testing.assert_allclose(float(tint.truncation_at(TPARAMS, torch.tensor(2.0))),
                               float(jint.truncation_at(PARAMS, 2.0)), rtol=1e-7)


@pytest.mark.parametrize("frame,cap", [(0, 4096), (2, 4096), (1, 32)])
def test_visible_block_indices_match(frames, frame, cap):
    D, _, P = frames
    jt, tt = _tables(D, P)
    pose = P[frame].copy()
    pose[0, 3] += 0.3  # part of the map leaves the view
    jpos, jcnt = jint.visible_block_indices(jt, INTR, jnp.asarray(pose), PARAMS, cap)
    tpos, tcnt = tint.visible_block_indices(tt, TINTR, torch.from_numpy(pose), TPARAMS, cap)
    assert int(tcnt) == int(jcnt) > 0
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    slots = ttab.lookup_blocks(tt, ttab.unpack_key(tt.keys[:16])).numpy()
    np.testing.assert_array_equal(
        slots, np.asarray(jtab.lookup_blocks(jt, jtab.unpack_key(jt.keys[:16]))))


def test_integrate_deintegrate_entry_points(frames):
    """The port's integrate = allocate + the fused op at sign +1, which is
    the JAX engine's ``tsdf_fast``; deintegrate at the same pose brings
    every weight and colour back to 0 when frames leave in reverse order
    (a block allocated by a later frame was not there when an earlier frame
    was fused, so removing the earlier one first would subtract from it)."""
    D, C, P = frames
    jt = jtab.create_table(4096, 2048)
    tt = ttab.create_table(4096, 2048, "cpu")
    for i in range(2):
        jt = jint.allocate_for_frame(jt, jnp.asarray(D[i]), INTR, jnp.asarray(P[i]), PARAMS)
        jt = japply.apply_tsdf_ops_xla(
            jt, jnp.asarray(D[i : i + 1]), jnp.asarray(C[i : i + 1]), jnp.asarray(P[i : i + 1]),
            jnp.ones((1,), jnp.float32), jnp.zeros((1,), jnp.int32), INTR, PARAMS)
        tint.integrate(tt, torch.from_numpy(D[i]), torch.from_numpy(C[i]), TINTR,
                       torch.from_numpy(P[i]), TPARAMS)
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(tt.weight.numpy(), np.asarray(jt.weight))
    np.testing.assert_allclose(tt.sdf.numpy(), np.asarray(jt.sdf), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt.color.numpy(), np.asarray(jt.color), rtol=0, atol=ATOL)
    for i in (1, 0):
        tint.deintegrate(tt, torch.from_numpy(D[i]), torch.from_numpy(C[i]), TINTR,
                         torch.from_numpy(P[i]), TPARAMS)
    assert float(tt.weight.abs().max()) == 0.0
    assert float(tt.color.abs().max()) < 1e-4


def test_starve_matches(frames):
    D, C, P = frames
    jt, tt = _tables(D, P)
    jt = japply.apply_tsdf_ops_xla(jt, jnp.asarray(D), jnp.asarray(C), jnp.asarray(P),
                                   jnp.ones((3,), jnp.float32), jnp.arange(3, dtype=jnp.int32),
                                   INTR, PARAMS)
    tt = ttab.VoxelBlockTable(**{
        f.name: torch.from_numpy(np.array(getattr(jt, f.name))[:, :4] if f.name == "slot_geo"
                                 else np.array(getattr(jt, f.name)))
        for f in dataclasses.fields(ttab.VoxelBlockTable)})
    jt = jtab.starve(jt, 1.0)
    ttab.starve(tt, 1.0)
    np.testing.assert_array_equal(tt.weight.numpy(), np.asarray(jt.weight))
    np.testing.assert_allclose(tt.color.numpy(), np.asarray(jt.color), rtol=0, atol=ATOL)


@pytest.mark.parametrize("sign,cap", [(1.0, 4096), (-1.0, 4096), (1.0, 64)])
def test_integrate_frame_matches(frames, sign, cap):
    """The standalone update ``integrate_frame`` over the
    ``visible_block_indices`` list (``tests/test_tsdf_integrate.py``'s
    entry point): fuse frames 0 and 1 into the same tables, then apply
    frame 2 with ``sign``. Weights equal; sdf and colour within ATOL."""
    D, C, P = frames
    jt, tt = _tables(D, P)
    for i in (0, 1, 2):
        s = 1.0 if i < 2 else sign
        jpos, _ = jint.visible_block_indices(jt, INTR, jnp.asarray(P[i]), PARAMS, cap)
        tpos, _ = tint.visible_block_indices(tt, TINTR, torch.from_numpy(P[i]), TPARAMS, cap)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        jt = jint.integrate_frame(jt, jnp.asarray(D[i]), jnp.asarray(C[i]), INTR,
                                  jnp.asarray(P[i]), PARAMS, jpos, sign=s)
        tint.integrate_frame(tt, torch.from_numpy(D[i]), torch.from_numpy(C[i]), TINTR,
                             torch.from_numpy(P[i]), TPARAMS, tpos, sign=s)
    jw = np.asarray(jt.weight)
    assert (jw > 0).sum() > 1000
    np.testing.assert_array_equal(tt.weight.numpy(), jw)
    np.testing.assert_allclose(tt.sdf.numpy(), np.asarray(jt.sdf), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt.color.numpy(), np.asarray(jt.color), rtol=0, atol=ATOL)
    assert float(tt.weight[-1].abs().max()) == 0.0   # the dummy row stays zero
