"""The fusion programs on device values: ``_tsdf_fast`` and ``_tsdf_rows``
of the port against the JAX engine's jitted ``tsdf_fast`` / ``tsdf_rows``.

The port's programs take the archive slot, the pose and the validity (and
the re-integration rows) as tensors on the device and compute their op
signs there, as the reference does; on the card they are replayed from CUDA
graphs, and on the CPU the same code runs eagerly. Both engines at the small
configuration of ``tests/test_torch_slice.py`` archive the same 6 frames of
``make_sequence(6)``; each call starts from the same table (fused by the
JAX engine from frames 0-3 at noisy poses, copied into the port's), and the
port's table after it is held to the JAX one's: the index arrays equal, the
payload as in ``tests/test_torch_slice.py`` (XLA:CPU contracts a*b+c into
FMAs, the port rounds every product: a voxel whose centre projects within
an ulp of a pixel edge may sample the neighbour, at most 1e-4 of the updated
voxels; the rest within 1e-5). An invalid current frame is a bitwise no-op
on the port's fast path. The rows program runs every row mode (0 skip, 1
de-integrate, 2 de- and re-integrate, 3 integrate) with the current frame
valid and invalid.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import AppConfig, BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence, orbit_trajectory
from bundlefusion_tpu.pipeline.frames import store_frame
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
from bundlefusion_tpu.pipeline.online import preprocess_frame as jax_preprocess
from bundlefusion_tpu.tsdf import table as jtab
import bundlefusion_tpu_torch.config as tcfg
from bundlefusion_tpu_torch.pipeline.online import REINT_ROWS
from bundlefusion_tpu_torch.pipeline.online import BundleFusion as TorchEngine
from bundlefusion_tpu_torch.tsdf import table as ttab
from tests.torch_parity import APP, BUNDLING, port_intr

N = 6
MAX_MOVED_FRACTION = 1e-4
ATOL = 1e-5
INDEX = ("keys", "slots", "free_list", "free_count", "num_alloc_failures", "slot_keys",
         "high_water")


def _jax_table(base: dict):
    """A fresh JAX table from numpy arrays (the jitted programs donate theirs)."""
    return jtab.VoxelBlockTable(**{k: jnp.asarray(v) for k, v in base.items()})


@pytest.fixture(scope="module")
def engines():
    intr = default_intrinsics(160, 120)
    seq = make_sequence(N, intr=intr)
    gt = orbit_trajectory(N)
    noisy = orbit_trajectory(N, noise=0.01)
    bund = dict(BUNDLING, submap_size=4)
    jeng = JaxEngine(intr, AppConfig(**APP), BundlingConfig(**bund), max_keyframes=8)
    teng = TorchEngine(port_intr(intr), tcfg.AppConfig(**APP), tcfg.BundlingConfig(**bund),
                       max_keyframes=8, device="cpu")
    sift_hw = (jeng.intr_sift.height, jeng.intr_sift.width)
    int_hw = (jeng.intr_int.height, jeng.intr_int.width)
    for i in range(N):
        d_u16, c_u8 = JaxEngine._to_wire(seq["depth"][i], seq["color"][i])
        depth = jnp.where(d_u16 > 0, jnp.asarray(d_u16).astype(jnp.float32) * 1e-3, jnp.nan)
        color = jnp.asarray(c_u8).astype(jnp.float32) * (1.0 / 255.0)
        _, _, d_int, c_int = jax_preprocess(depth, color, sift_hw, int_hw)
        jeng.store = store_frame(jeng.store, i, d_int, c_int)
        teng._archive_frame(d_u16, c_u8, i)
    # the archives must agree for the comparison to hold the programs alone:
    # the port's copy of the JAX archive
    teng.store.depth_mm.copy_(torch.from_numpy(np.asarray(jeng.store.depth_mm).astype(np.int32))
                              .to(teng.store.depth_mm.dtype))
    teng.store.color.copy_(torch.from_numpy(np.array(jeng.store.color)))
    jt = jeng.table
    for i in range(4):
        jt = jeng._tsdf_fast(jt, jeng.store, jnp.asarray(i, jnp.int32),
                             jnp.asarray(noisy[i]), jnp.asarray(True))
    base = {k: np.array(v) for k, v in jt._asdict().items()}
    return jeng, teng, base, gt, noisy


def _start(teng, base):
    """The port engine's table holds the JAX base table (in its own storages)."""
    from bundlefusion_tpu_torch.utils import copy_into

    copy_into(teng.table, ttab.table_from_numpy(base, "cpu"))


def _assert_tables(jt, tt):
    for name in INDEX:
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)), getattr(tt, name).numpy(),
                                      err_msg=name)
    jw, tw = np.asarray(jt.weight), tt.weight.numpy()
    updated = int((jw > 0).sum())
    moved = (jw != tw).any(axis=1)
    assert int((jw != tw).sum()) <= MAX_MOVED_FRACTION * updated
    keep = ~moved
    np.testing.assert_allclose(tt.sdf.numpy()[keep], np.asarray(jt.sdf)[keep], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt.color.numpy()[keep], np.asarray(jt.color)[keep], rtol=0,
                               atol=ATOL)


def _dev(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("valid", [True, False])
def test_tsdf_fast_on_device_values_matches_jax(engines, valid):
    jeng, teng, base, _, noisy = engines
    f = 4
    jt = jeng._tsdf_fast(_jax_table(base), jeng.store, jnp.asarray(f, jnp.int32),
                         jnp.asarray(noisy[f]), jnp.asarray(valid))
    _start(teng, base)
    before = teng.table.clone()
    teng._tsdf_fast(_dev([f], torch.int64), _dev(noisy[f], torch.float32), _dev(valid))
    _assert_tables(jt, teng.table)
    if valid:
        assert not torch.equal(teng.table.weight, before.weight)
    else:
        # sign 0 and nothing allocated: every tensor keeps its bits
        for fld in dataclasses.fields(before):
            assert torch.equal(getattr(teng.table, fld.name), getattr(before, fld.name)), fld.name


def _rows(gt, noisy):
    """Re-integration rows [R, 34] (fid | mode | T_old | T_new) with every
    mode: de-integrate frame 0, de- and re-integrate frames 1 and 3, skip,
    integrate frame 4 (never fused)."""
    eye = np.eye(4, dtype=np.float32)
    spec = [(0, 1, noisy[0], eye), (1, 2, noisy[1], gt[1]), (2, 0, eye, eye),
            (4, 3, eye, gt[4]), (3, 2, noisy[3], gt[3])]
    assert len(spec) == REINT_ROWS
    packed = np.zeros((REINT_ROWS, 34), np.float32)
    for i, (fid, mode, To, Tn) in enumerate(spec):
        packed[i, 0], packed[i, 1] = fid, mode
        packed[i, 2:18], packed[i, 18:34] = To.reshape(-1), Tn.reshape(-1)
    return packed


@pytest.mark.parametrize("cur_valid", [True, False])
def test_tsdf_rows_on_device_values_matches_jax(engines, cur_valid):
    jeng, teng, base, gt, noisy = engines
    packed = _rows(gt, noisy)
    f = 5
    jt = jeng._tsdf_rows(_jax_table(base), jeng.store, jnp.asarray(packed),
                         jnp.asarray(f, jnp.int32), jnp.asarray(noisy[f]), jnp.asarray(cur_valid))
    _start(teng, base)
    before = teng.table.weight.clone()
    teng._tsdf_rows(_dev(packed, torch.float32), _dev([f], torch.int64),
                    _dev(noisy[f], torch.float32), _dev(cur_valid))
    _assert_tables(jt, teng.table)
    assert not torch.equal(teng.table.weight, before)


def test_dispatch_takes_device_and_host_values_alike(engines):
    """``_tsdf_dispatch`` with the pose and validity as device tensors (the
    frame program's outputs) and as host values gives the same bits."""
    _, teng, base, _, noisy = engines
    out = []
    for pose, valid in ((_dev(noisy[4], torch.float32), _dev(True)), (noisy[4], True)):
        _start(teng, base)
        teng._tsdf_dispatch(4, pose, valid)
        out.append(teng.table.clone())
    for fld in dataclasses.fields(out[0]):
        assert torch.equal(getattr(out[0], fld.name), getattr(out[1], fld.name)), fld.name
