"""Port voxel-block table against the JAX package: every array equal.

The table's index arithmetic is integer-exact, so every array (keys,
slots, free list, counters, slot-major map, slot geometry lanes 0-3 and the
payload) must be bitwise equal to the reference after the same calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.tsdf import integrate as jint
from bundlefusion_tpu.tsdf import table as jtab
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.tsdf import integrate as tint
from bundlefusion_tpu_torch.tsdf import table as ttab

INDEX_FIELDS = ("keys", "slots", "free_list", "free_count", "num_alloc_failures",
                "slot_keys", "high_water")


def assert_tables_equal(jt, tt):
    for name in INDEX_FIELDS + ("sdf", "weight", "color"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      getattr(tt, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jt.slot_geo)[:, :4], tt.slot_geo.numpy())


def assert_clean(tt):
    errs = ttab.check_invariants(tt)
    assert all(v == 0 for v in errs.values()), errs


@pytest.mark.parametrize("capacity,num_blocks", [(256, 128), (1000, 200), (4096, 2048)])
def test_create_table_shapes(capacity, num_blocks):
    jt = jtab.create_table(capacity, num_blocks)
    tt = ttab.create_table(capacity, num_blocks, "cpu")
    assert tt.num_blocks == jt.num_blocks and tt.num_blocks % 128 == 0
    assert_tables_equal(jt, tt)
    assert_clean(tt)


def _alloc_both(jt, tt, packed, compact=jtab.ALLOC_COMPACT):
    packed = np.asarray(packed, np.int32)
    jt = jtab.allocate_packed(jt, jnp.asarray(packed), compact=compact)
    tt = ttab.allocate_packed(tt, torch.from_numpy(packed.copy()), compact=compact)
    return jt, tt


def _keys(rng, n, lo=0, hi=1 << 20):
    return rng.integers(lo, hi, size=n).astype(np.int32)


@pytest.mark.parametrize("case", ["dedup_runs", "compact_budget", "free_list_exhausted",
                                  "key_capacity_overflow", "present_keys"])
def test_allocate_packed_cases(case):
    rng = np.random.default_rng(7)
    E = ttab.EMPTY_KEY
    if case == "dedup_runs":
        jt, tt = jtab.create_table(512, 256), ttab.create_table(512, 256, "cpu")
        runs = np.repeat(_keys(rng, 40), rng.integers(1, 6, size=40))
        runs[rng.random(runs.shape) < 0.1] = E
        jt, tt = _alloc_both(jt, tt, runs)
    elif case == "compact_budget":
        jt, tt = jtab.create_table(512, 256), ttab.create_table(512, 256, "cpu")
        jt, tt = _alloc_both(jt, tt, _keys(rng, 100), compact=16)  # defers the rest
        assert int(tt.free_count) == 256 - 16
    elif case == "free_list_exhausted":
        jt, tt = jtab.create_table(1024, 128), ttab.create_table(1024, 128, "cpu")
        jt, tt = _alloc_both(jt, tt, np.unique(_keys(rng, 300)))
        assert int(tt.free_count) == 0 and int(tt.num_alloc_failures) > 0
    elif case == "key_capacity_overflow":
        jt, tt = jtab.create_table(64, 256), ttab.create_table(64, 256, "cpu")
        jt, tt = _alloc_both(jt, tt, np.unique(_keys(rng, 100)))
        assert int(tt.num_alloc_failures) > 0
    else:
        jt, tt = jtab.create_table(512, 256), ttab.create_table(512, 256, "cpu")
        first = _keys(rng, 50)
        jt, tt = _alloc_both(jt, tt, first)
        jt, tt = _alloc_both(jt, tt, np.concatenate([first[::2], _keys(rng, 30)]))
    assert_tables_equal(jt, tt)
    if case != "key_capacity_overflow":  # overflow drops keys: accounting breaks
        assert_clean(tt)


def _three_frame_tables():
    intr_in = default_intrinsics(160, 120)
    intr = intr_in.scaled(80, 60)
    jp = jint.TsdfParams(voxel_size=0.04, truncation=0.12, max_integration_distance=4.0)
    tp = tint.TsdfParams(**jp.__dict__)
    ti = CameraIntrinsics(**intr.__dict__)
    seq = make_sequence(3, intr=intr_in)
    jt, tt = jtab.create_table(4096, 2048), ttab.create_table(4096, 2048, "cpu")
    for i in range(3):
        d = seq["depth"][i][::2, ::2]
        T = seq["poses"][i]
        jt = jint.allocate_for_frame(jt, jnp.asarray(d), intr, jnp.asarray(T), jp)
        tt = tint.allocate_for_frame(tt, torch.from_numpy(d), ti, torch.from_numpy(T), tp)
        # the engine's fused path: packed candidate keys
        kj = np.asarray(jint.candidate_keys(jnp.asarray(d), intr, jnp.asarray(T), jp))
        kt = tint.candidate_keys(torch.from_numpy(d), ti, torch.from_numpy(T), tp)
        np.testing.assert_array_equal(kj, kt.numpy())
    return jt, tt


def test_allocate_three_frame_sequence():
    jt, tt = _three_frame_tables()
    assert int(ttab.num_occupied(tt)) > 100
    assert_tables_equal(jt, tt)
    assert_clean(tt)


def _weights_for(tt, jt, rng, frac):
    """Give a random share of live blocks nonzero weight in both tables."""
    live = tt.slot_keys[:-1].numpy() != ttab.EMPTY_KEY
    rows = np.nonzero(live)[0]
    hot = rows[rng.random(rows.shape) < frac]
    w = np.zeros(tuple(tt.weight.shape), np.float32)
    w[hot, rng.integers(0, 512, size=hot.shape)] = 1.0
    tt.weight.copy_(torch.from_numpy(w))
    tt.sdf.copy_(torch.from_numpy(w * 0.5))
    return jt._replace(weight=jnp.asarray(w), sdf=jnp.asarray(w * 0.5))


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_garbage_collect(frac):
    jt, tt = _three_frame_tables()
    jt = _weights_for(tt, jt, np.random.default_rng(3), frac)
    jt = jtab.garbage_collect(jt)
    tt = ttab.garbage_collect(tt)
    assert_tables_equal(jt, tt)
    assert_clean(tt)


def test_free_blocks_then_reallocate():
    jt, tt = _three_frame_tables()
    mask = np.random.default_rng(4).random(jt.capacity) < 0.3
    jt = jtab.free_blocks(jt, jnp.asarray(mask))
    tt = ttab.free_blocks(tt, torch.from_numpy(mask))
    assert_tables_equal(jt, tt)
    assert_clean(tt)
    # freed slots are reused first
    jt, tt = _alloc_both(jt, tt, np.unique(_keys(np.random.default_rng(5), 64)))
    assert_tables_equal(jt, tt)
    assert_clean(tt)


def test_lookup_and_invariant_detection():
    jt, tt = _three_frame_tables()
    keys = tt.keys.numpy()
    q = np.concatenate([keys[:20], _keys(np.random.default_rng(6), 20)])
    np.testing.assert_array_equal(
        np.asarray(jtab.lookup_packed(jt, jnp.asarray(q))),
        ttab.lookup_packed(tt, torch.from_numpy(q)).numpy(),
    )
    coords = ttab.unpack_key(torch.from_numpy(keys[:20]))
    np.testing.assert_array_equal(ttab.pack_block_coords(coords).numpy(), keys[:20])
    # check_invariants reports a broken table the way the reference does
    bad = tt.clone()
    bad.slot_keys[0] = 12345
    errs_t = ttab.check_invariants(bad)
    errs_j = jtab.check_invariants(jt._replace(slot_keys=jnp.asarray(bad.slot_keys.numpy())))
    assert errs_t == errs_j and errs_t["slot_keys_mismatch"] == 1


@pytest.mark.parametrize("window", [256, 96, 0])
def test_defrag_prefix_matches(window):
    """``defrag_prefix`` on the pattern of ``tests/test_tsdf_table.py``
    (two interleaved allocation batches with payload fingerprints, a free
    that punches holes; the full window, a partial one, an empty one), then
    a later allocation: every array equal to the reference's."""
    rng = np.random.default_rng(0)
    jt = jtab.create_table(1024, 256)
    for lo, hi in ((-8, 0), (0, 8)):
        c = rng.integers(lo, hi, size=(40, 3)).astype(np.int32)
        jt = jtab.allocate(jt, jnp.asarray(c), jnp.ones(40, bool))
    sk = np.asarray(jt.slot_keys[:256])
    live = sk != int(jtab.EMPTY_KEY)
    fp = np.where(live, sk % 1000, 0).astype(np.float32)
    jt = jt._replace(
        sdf=jt.sdf.at[:256].set(jnp.asarray(fp)[:, None] * jnp.ones((1, 512))),
        weight=jt.weight.at[:256].set(jnp.asarray(live, jnp.float32)[:, None]
                                      * jnp.ones((1, 512))),
        color=jt.color.at[:256].set(jnp.asarray(fp)[:, None] * jnp.ones((1, 1536)) * 0.5),
    )
    jt = jtab.free_blocks(jt, (jt.keys != jtab.EMPTY_KEY) & (jt.keys % 7 == 0))
    tt = ttab.table_from_numpy({f: np.asarray(v) for f, v in jt._asdict().items()}, "cpu")
    assert_tables_equal(jt, tt)
    jt = jtab.defrag_prefix(jt, window)
    ttab.defrag_prefix(tt, window)
    assert_tables_equal(jt, tt)
    assert_clean(tt)
    c3 = rng.integers(20, 28, size=(20, 3)).astype(np.int32)
    jt = jtab.allocate(jt, jnp.asarray(c3), jnp.ones(20, bool))
    ttab.allocate(tt, torch.from_numpy(c3), torch.ones(20, dtype=torch.bool))
    assert_tables_equal(jt, tt)
    assert_clean(tt)


def test_table_from_numpy_checks_slot_keys():
    jt = jtab.allocate(jtab.create_table(256, 128), jnp.asarray([[1, 2, 3], [4, 5, 6]]),
                       jnp.ones(2, bool))
    arrays = {f: np.asarray(v) for f, v in jt._asdict().items()}
    tt = ttab.table_from_numpy(arrays, "cpu")
    assert_tables_equal(jt, tt)
    assert tt.slot_geo.shape == (129, ttab.SLOT_GEO_LANES)
    bad = dict(arrays, slot_keys=np.roll(arrays["slot_keys"], 1))
    with pytest.raises(ValueError, match="slot_keys"):
        ttab.table_from_numpy(bad, "cpu")
