"""Host paging of TSDF blocks in the port (``tsdf/streaming.py``,
``allocate_packed(blocked=...)`` and the engine's sweeps) against the JAX
package.

1. The functions on the same table: the setup of ``tests/test_streaming.py``
   (a near and a far cluster of blocks with distinctive payloads, 5 cm
   voxels) built by the JAX package and carried into the port.
   ``stream_out`` / ``stream_in_keys`` / ``stream_in`` and
   ``paged_keys_in_frustum`` give the same host keys in the same order, the
   same payloads bit for bit and the same table; ``allocate_packed`` with
   paged keys gives the same table.
2. The three engine tests of ``tests/test_streaming_engine.py`` on the port
   alone (pages out and back; a re-integration over a paged region pages
   it in first and ends with the volume of a never-paged twin, weights
   equal and sdf within 1e-6 by key; a round trip keeps the mesh).
3. The port's paging engine against the JAX paging engine, both driven
   through the fusion half at the same poses (the order of
   ``tests/test_torch_slice.py``), after forced sweeps: the same paged keys,
   and payloads within that file's tolerances (the two packages' FMA
   contraction differs, so a voxel within an ulp of a pixel edge may sample
   its neighbour: such voxels, whose weight, sdf or colour differ, are at
   most 1e-4 of the updated ones; sdf / colour within 1e-5 elsewhere).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import AppConfig as JaxApp
from bundlefusion_tpu.config import BundlingConfig as JaxBundling
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence, orbit_trajectory
from bundlefusion_tpu.pipeline.frames import store_frame
from bundlefusion_tpu.pipeline.online import BundleFusion as JaxEngine
from bundlefusion_tpu.pipeline.online import preprocess_frame as jax_preprocess
from bundlefusion_tpu.tsdf import streaming as jstream
from bundlefusion_tpu.tsdf import table as jtab
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.io.synthetic import make_sequence as port_sequence
from bundlefusion_tpu_torch.pipeline.online import BundleFusion
from bundlefusion_tpu_torch.tsdf import integrate as tint
from bundlefusion_tpu_torch.tsdf import streaming as tstream
from bundlefusion_tpu_torch.tsdf import table as ttab
from tests.torch_parity import APP, BUNDLING, SIFT, fields_np

VOXEL = 0.05  # block extent 0.4 m
MAX_MOVED_FRACTION = 1e-4
ATOL = 1e-5
INDEX = ("keys", "slots", "free_list", "free_count", "num_alloc_failures", "slot_keys",
         "high_water")


def assert_tables_equal(jt, tt):
    for name in INDEX + ("sdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tt.slot_geo.numpy(), np.asarray(jt.slot_geo)[:, :4])


def assert_stores_equal(js, ts):
    assert list(ts.blocks) == list(js.blocks)
    for k, (s, w, c) in js.blocks.items():
        ps, pw, pc = ts.blocks[k]
        np.testing.assert_array_equal(ps, s)
        np.testing.assert_array_equal(pw, w)
        np.testing.assert_array_equal(pc, np.asarray(c).reshape(-1))


def _clusters(seed=0):
    rng = np.random.default_rng(seed)
    t = jtab.create_table(1024, 512)
    near = rng.integers(-2, 2, size=(30, 3)).astype(np.int32)
    far = rng.integers(8, 12, size=(30, 3)).astype(np.int32)
    coords = np.concatenate([near, far])
    t = jtab.allocate(t, jnp.asarray(coords), jnp.ones(len(coords), bool))
    slots = np.asarray(jtab.lookup_blocks(t, jnp.asarray(coords)))
    sdf, w, c = np.asarray(t.sdf).copy(), np.asarray(t.weight).copy(), np.asarray(t.color).copy()
    for i, s in enumerate(slots):
        sdf[s] = rng.uniform(-1, 1, sdf.shape[1])
        w[s] = float(i + 1)
        c[s] = rng.uniform(0, 1, c.shape[1])
    t = t._replace(sdf=jnp.asarray(sdf), weight=jnp.asarray(w), color=jnp.asarray(c))
    return t, ttab.table_from_numpy(fields_np(t), "cpu"), far


def test_stream_out_in_matches():
    jt, tt, far = _clusters()
    js, ts = jstream.HostBlockStore(), tstream.HostBlockStore()
    jt = jstream.stream_out(jt, js, np.zeros(3), radius=2.0, voxel_size=VOXEL)
    tstream.stream_out(tt, ts, np.zeros(3), radius=2.0, voxel_size=VOXEL)
    assert len(ts) > 10
    assert_stores_equal(js, ts)
    assert_tables_equal(jt, tt)
    assert all(v == 0 for v in ttab.check_invariants(tt).values())
    # an explicit subset, then the rest by radius around the far cluster
    some = list(ts.blocks)[:7]
    jt = jstream.stream_in_keys(jt, js, some)
    tstream.stream_in_keys(tt, ts, some)
    assert_stores_equal(js, ts)
    assert_tables_equal(jt, tt)
    cam2 = (np.array([10, 10, 10]) + 0.5) * 8 * VOXEL
    jt = jstream.stream_in(jt, js, cam2, radius=2.0, voxel_size=VOXEL)
    tstream.stream_in(tt, ts, cam2, radius=2.0, voxel_size=VOXEL)
    assert len(ts) == len(js) == 0
    assert_tables_equal(jt, tt)
    back = ttab.lookup_blocks(tt, torch.from_numpy(np.unique(far, axis=0)))
    assert (back >= 0).all()
    assert all(v == 0 for v in ttab.check_invariants(tt).values())


def test_stream_out_in_batches_of_free_compact():
    """More blocks than one ``free_blocks`` call zeroes: the frees run in
    batches and every freed row is zero again."""
    n = ttab.FREE_COMPACT + 300
    coords = np.stack(np.unravel_index(np.arange(n), (40, 40, 40)), -1).astype(np.int32) + 20
    jt = jtab.allocate_packed(jtab.create_table(8192, 4096),
                              jtab.pack_block_coords(jnp.asarray(coords)), compact=8192)
    jt = jt._replace(weight=jt.weight.at[:-1].add(1.0))   # the dummy row stays zero
    tt = ttab.table_from_numpy(fields_np(jt), "cpu")
    js, ts = jstream.HostBlockStore(), tstream.HostBlockStore()
    jt = jstream.stream_out(jt, js, np.zeros(3), radius=1.0, voxel_size=VOXEL)
    tstream.stream_out(tt, ts, np.zeros(3), radius=1.0, voxel_size=VOXEL)
    assert len(ts) == n
    assert_stores_equal(js, ts)
    assert_tables_equal(jt, tt)
    assert int(tt.num_alloc_failures) == 0


@pytest.mark.parametrize("shift", [0.0, 1.5])
def test_paged_keys_in_frustum_matches(shift):
    jt, tt, far = _clusters(1)
    js, ts = jstream.HostBlockStore(), tstream.HostBlockStore()
    jstream.stream_out(jt, js, np.zeros(3), radius=0.5, voxel_size=VOXEL)
    tstream.stream_out(tt, ts, np.zeros(3), radius=0.5, voxel_size=VOXEL)
    poses = orbit_trajectory(3)
    poses[:, 0, 3] += shift
    params = tint.TsdfParams(voxel_size=VOXEL, truncation=0.15, max_integration_distance=6.0,
                             depth_max=6.0)
    intr = default_intrinsics(80, 60)
    tk = tstream.paged_keys_in_frustum(ts, poses, CameraIntrinsics(**intr.__dict__), params,
                                       60, 80)
    jk = jstream.paged_keys_in_frustum(js, poses, intr, params, 60, 80)
    np.testing.assert_array_equal(tk, jk)
    assert 0 < len(tk) < len(ts)
    assert len(tstream.paged_keys_in_frustum(tstream.HostBlockStore(), poses, intr, params,
                                             60, 80)) == 0


@pytest.mark.parametrize("case", ["literal", "random"])
def test_allocate_blocked_matches(case):
    if case == "literal":
        cand = np.asarray([5, 5, 9, 12, 12, 12, 20], np.int32)
        blocked = np.sort(np.asarray([9, 12] + [jtab.EMPTY_KEY] * 14, np.int64)).astype(np.int32)
    else:
        rng = np.random.default_rng(3)
        cand = np.sort(rng.integers(0, 1 << 20, 600)).astype(np.int32)
        blocked = np.full(256, jtab.EMPTY_KEY, np.int64)
        blocked[:100] = np.sort(rng.choice(cand, 100, replace=False))
        blocked = blocked.astype(np.int32)
    jt = jtab.allocate_packed(jtab.create_table(2048, 1024), jnp.asarray(cand),
                              blocked=jnp.asarray(blocked))
    tt = ttab.allocate_packed(ttab.create_table(2048, 1024, "cpu"), torch.from_numpy(cand),
                              blocked=torch.from_numpy(blocked))
    assert_tables_equal(jt, tt)
    keys = tt.keys.numpy()
    live = set(keys[keys != ttab.EMPTY_KEY].tolist())
    assert not live & set(blocked.tolist())
    if case == "literal":
        assert live == {5, 20}


# ---- 2. the engine tests of tests/test_streaming_engine.py, on the port ----

def _small_engine(streaming: bool, top_n_active: int = 0):
    intr = default_intrinsics(160, 120)
    app = port.AppConfig(**dict(APP, streaming_enabled=streaming, streaming_radius=6.0,
                                streaming_every=4, streaming_blocked_cap=8192,
                                top_n_active=top_n_active))
    return BundleFusion(CameraIntrinsics(**intr.__dict__), app,
                        port.BundlingConfig(**dict(BUNDLING, submap_size=4)),
                        sift_cfg=port.SiftConfig(**SIFT), max_keyframes=8, device="cpu")


def _live(table) -> int:
    return int((table.keys != ttab.EMPTY_KEY).sum())


def _far_pose():
    far = np.eye(4, dtype=np.float32)
    far[:3, 3] = [50.0, 0.0, 0.0]
    return far


def _payload_by_key(table):
    keys, slots = table.keys.numpy(), table.slots.numpy()
    occ = keys != ttab.EMPTY_KEY
    sdf, w = table.sdf.numpy(), table.weight.numpy()
    # copies: the table is updated in place
    return {int(k): (sdf[s].copy(), w[s].copy()) for k, s in zip(keys[occ], slots[occ])}


@pytest.fixture(scope="module")
def seq9():
    return port_sequence(9, intr=default_intrinsics(160, 120))


@pytest.fixture(scope="module")
def paged_run(seq9):
    """Nine frames through ``process_frame`` with paging on and
    re-integration off (the reference's paging regime); the natural sweeps
    at frames 4 and 8 page nothing within 6 m."""
    eng = _small_engine(streaming=True)
    for i in range(9):
        eng.process_frame(seq9["depth"][i], seq9["color"][i])
    eng._flush_pending()
    assert len(eng.host_blocks) == 0
    return eng


def test_streaming_pages_out_and_back(paged_run, seq9):
    eng = copy.deepcopy(paged_run)
    eng.sift_world.append(_far_pose())
    eng._stream_update()
    paged = len(eng.host_blocks)
    assert paged > 0 and _live(eng.table) == 0
    assert (eng._blocked_dev[:paged].diff() > 0).all()
    assert all(v == 0 for v in ttab.check_invariants(eng.table).values())
    # the allocation must not resurrect paged blocks (no sweep in between)
    eng.sift_world[-1] = seq9["poses"][8]
    eng.process_frame(seq9["depth"][8], seq9["color"][8])
    eng._flush_pending()
    live_mid = _live(eng.table)
    assert live_mid <= 64, live_mid
    # back in: paged blocks return with their payload
    eng._stream_update()
    assert len(eng.host_blocks) < paged
    assert _live(eng.table) > live_mid
    assert all(v == 0 for v in ttab.check_invariants(eng.table).values())


def test_streaming_roundtrip_preserves_mesh(paged_run, seq9):
    eng = copy.deepcopy(paged_run)
    before = _payload_by_key(eng.table)
    eng.sift_world.append(_far_pose())
    eng._stream_update()
    assert len(eng.host_blocks) > 0
    eng.sift_world[-1] = seq9["poses"][0]
    eng._stream_update()
    assert len(eng.host_blocks) == 0
    after = _payload_by_key(eng.table)
    assert set(after) == set(before)
    for k, (s, w) in before.items():
        np.testing.assert_array_equal(after[k][0], s)
        np.testing.assert_array_equal(after[k][1], w)
    verts, _ = eng.extract_mesh()
    assert len(verts) > 1000


def test_reintegration_over_paged_region_streams_in_first(seq9):
    """De-integrating frame 0 while its blocks sit on the host must page
    them in first: the paged engine ends with the never-paged twin's
    volume (without the stream-in the paged blocks would keep frame 0's
    contribution)."""
    eng, twin = _small_engine(True, top_n_active=4), _small_engine(False, top_n_active=4)
    for i in range(9):
        eng.process_frame(seq9["depth"][i], seq9["color"][i])
        twin.process_frame(seq9["depth"][i], seq9["color"][i])
    eng._flush_pending()
    twin._flush_pending()
    eng.sift_world.append(_far_pose())
    eng._stream_update()
    assert len(eng.host_blocks) > 0
    eng.sift_world[-1] = seq9["poses"][0]
    for e in (eng, twin):
        poses = np.stack(e.complete_traj)
        valid = np.isfinite(poses).all(axis=(1, 2))
        valid[0] = False
        e.traj_manager.update_optimized_transforms(poses, valid)
        e._tsdf_dispatch()
    eng._stream_update()
    assert len(eng.host_blocks) == 0
    pa, pb = _payload_by_key(eng.table), _payload_by_key(twin.table)
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k][1], pb[k][1], err_msg=f"weight, block {k}")
        np.testing.assert_allclose(pa[k][0], pb[k][0], rtol=0, atol=1e-6,
                                   err_msg=f"sdf, block {k}")
    assert all(v == 0 for v in ttab.check_invariants(eng.table).values())
    assert int(eng.table.num_alloc_failures) == 0


# ---- 3. the port's paging engine against the JAX paging engine ----

N_FRAMES = 9


@pytest.fixture(scope="module")
def both_paging():
    """Both engines through the fusion half (archive, TSDF dispatch,
    bookkeeping) at the same noisy poses, paging on with re-integration;
    the noise-free poses are pushed after frame 4 so rows run."""
    intr = default_intrinsics(160, 120)
    seq = make_sequence(N_FRAMES, intr=intr)
    gt, noisy = orbit_trajectory(N_FRAMES), orbit_trajectory(N_FRAMES, noise=0.01)
    # no natural sweep (streaming_every > frames); forced sweeps page out
    # what lies beyond 1 m of the camera
    kw = dict(APP, streaming_enabled=True, streaming_radius=1.0, streaming_every=100,
              streaming_blocked_cap=8192)
    bkw = dict(BUNDLING, submap_size=4)
    jeng = JaxEngine(intr, JaxApp(**kw), JaxBundling(**bkw), max_keyframes=8)
    teng = BundleFusion(CameraIntrinsics(**intr.__dict__), port.AppConfig(**kw),
                        port.BundlingConfig(**bkw), max_keyframes=8, device="cpu")
    sift_hw = (jeng.intr_sift.height, jeng.intr_sift.width)
    int_hw = (jeng.intr_int.height, jeng.intr_int.width)
    for i in range(N_FRAMES):
        d_u16, c_u8 = JaxEngine._to_wire(seq["depth"][i], seq["color"][i])
        slot = jeng._store_slot(i)
        depth = jnp.where(d_u16 > 0, jnp.asarray(d_u16).astype(jnp.float32) * 1e-3, jnp.nan)
        color = jnp.asarray(c_u8).astype(jnp.float32) * (1.0 / 255.0)
        _, _, d_int, c_int = jax_preprocess(depth, color, sift_hw, int_hw)
        jeng.store = store_frame(jeng.store, slot, d_int, c_int)
        jeng._tsdf_dispatch(slot, jnp.asarray(noisy[i]), jnp.asarray(True))
        jeng._record_frame(i, noisy[i], True)
        teng._archive_frame(d_u16, c_u8, teng._store_slot(i))
        teng._tsdf_dispatch(teng._store_slot(i), noisy[i], True)
        teng._record_frame(i, noisy[i], True)
        if i == 4:
            for e in (jeng, teng):
                e.complete_traj = [gt[f].copy() for f in range(len(e.complete_traj))]
                e._push_optimized_to_manager()
    return jeng, teng, gt


def _assert_rows_close(jw, tw, js, ts, jc, tc, min_updated=1000):
    """Payload rows [k, 512] / colour [k, 1536]: voxels whose weight, sdf or
    colour differ beyond ATOL (a sample on the other side of an ulp-edge)
    are at most MAX_MOVED_FRACTION of the updated voxels."""
    updated = int((jw > 0).sum())
    assert updated > min_updated
    off = (jw != tw) | (np.abs(js - ts) > ATOL)
    off |= (np.abs(jc - tc) > ATOL).reshape(len(jc), 3, -1).any(axis=1)
    assert int(off.sum()) <= MAX_MOVED_FRACTION * updated, (int(off.sum()), updated)


def _assert_payloads_close(jtable, ttable):
    """The same keys; payloads by key as ``_assert_rows_close``."""
    jk, tk = np.asarray(jtable.keys), ttable.keys.numpy()
    np.testing.assert_array_equal(tk, jk)
    occ = jk != ttab.EMPTY_KEY
    js, ts = np.asarray(jtable.slots)[occ], ttable.slots.numpy()[occ]
    _assert_rows_close(np.asarray(jtable.weight)[js], ttable.weight.numpy()[ts],
                       np.asarray(jtable.sdf)[js], ttable.sdf.numpy()[ts],
                       np.asarray(jtable.color)[js], ttable.color.numpy()[ts])


def _assert_host_stores_close(js, ts):
    assert sorted(ts.blocks) == sorted(js.blocks) and len(ts) > 0
    keys = sorted(ts.blocks)

    def stack(store, j):
        return np.stack([np.asarray(store.blocks[k][j]).reshape(-1) for k in keys])

    _assert_rows_close(stack(js, 1), stack(ts, 1), stack(js, 0), stack(ts, 0),
                       stack(js, 2), stack(ts, 2), min_updated=0)


def test_paging_engine_matches_jax_after_forced_sweeps(both_paging):
    jeng, teng, gt = both_paging
    assert teng.reint_frames == jeng.reint_frames > 0
    _assert_payloads_close(jeng.table, teng.table)
    # a sweep around a camera moved into the scene: part of it leaves,
    # part stays
    side = gt[0].copy()
    side[:3, 3] += [0.0, 0.0, 1.2]
    for e in (jeng, teng):
        e.sift_world.append(side.copy())
        e._stream_update()
    _assert_host_stores_close(jeng.host_blocks, teng.host_blocks)
    assert 0 < len(teng.host_blocks) and _live(teng.table) > 0
    np.testing.assert_array_equal(teng._blocked_dev.numpy(), np.asarray(jeng._blocked_dev))
    _assert_payloads_close(jeng.table, teng.table)
    # a re-integration row over the paged region pages it in first in both
    for e in (jeng, teng):
        poses = np.stack(e.complete_traj)
        valid = np.isfinite(poses).all(axis=(1, 2))
        valid[1] = False
        e.traj_manager.update_optimized_transforms(poses, valid)
        e._tsdf_dispatch()
    assert len(teng.host_blocks) == len(jeng.host_blocks)
    if len(jeng.host_blocks):
        _assert_host_stores_close(jeng.host_blocks, teng.host_blocks)
    _assert_payloads_close(jeng.table, teng.table)
    # the rest back by key
    keys = sorted(jeng.host_blocks.blocks)
    jeng.table = jstream.stream_in_keys(jeng.table, jeng.host_blocks, keys)
    tstream.stream_in_keys(teng.table, teng.host_blocks, keys)
    assert len(teng.host_blocks) == len(jeng.host_blocks) == 0
    _assert_payloads_close(jeng.table, teng.table)
    assert all(v == 0 for v in ttab.check_invariants(teng.table).values())


def test_natural_sweeps_centre_on_the_jax_engines_frames(seq9):
    """Both engines through ``process_frame`` with a sweep at every frame:
    each sweep centres on the same recorded frame (the latest
    ``sift_world`` entry). The JAX engine records a boundary's frames when it
    retires the pack at the start of the next frame, the port at the end of
    the boundary frame; a sweep runs before the frame's boundary dispatch,
    so both see the same list (on the CPU, where the JAX pack is ready by
    the next frame)."""
    from bundlefusion_tpu.ops.sift import SiftConfig as JaxSift

    intr = default_intrinsics(160, 120)
    kw = dict(APP, streaming_enabled=True, streaming_radius=6.0, streaming_every=1,
              streaming_blocked_cap=8192, top_n_active=0)
    bkw = dict(BUNDLING, submap_size=4)
    jeng = JaxEngine(intr, JaxApp(**kw), JaxBundling(**bkw), sift_cfg=JaxSift(**SIFT),
                     max_keyframes=8)
    teng = BundleFusion(CameraIntrinsics(**intr.__dict__), port.AppConfig(**kw),
                        port.BundlingConfig(**bkw), sift_cfg=port.SiftConfig(**SIFT),
                        max_keyframes=8, device="cpu")
    centres = {"jax": [], "port": []}
    for name, e in (("jax", jeng), ("port", teng)):
        def sweep(inner=e._stream_update, e=e, name=name):
            centres[name].append((e.frame_idx, len(e.sift_world) - 1))
            inner()
        e._stream_update = sweep
    for i in range(9):
        jeng.process_frame(seq9["depth"][i], seq9["color"][i])
        teng.process_frame(seq9["depth"][i], seq9["color"][i])
    assert centres["port"] == centres["jax"]
    assert [c for _, c in centres["port"]] == [-1] * 4 + [4] * 4
    assert len(teng.host_blocks) == len(jeng.host_blocks) == 0
