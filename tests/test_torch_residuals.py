"""The port's correspondence store against the JAX package: every operation
on the same seeded batches, results exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.solver import residuals as jr
from bundlefusion_tpu_torch.solver import residuals as tr
from tests.torch_parity import fields_np, t

CAP = 64


def _batch(rng, n, p_valid=0.6):
    return dict(
        img_i=rng.integers(0, 6, n).astype(np.int32), img_j=rng.integers(0, 6, n).astype(np.int32),
        p_i=rng.normal(size=(n, 3)).astype(np.float32), p_j=rng.normal(size=(n, 3)).astype(np.float32),
        valid=rng.random(n) < p_valid,
        key_i=rng.integers(0, 500, n).astype(np.int32), key_j=rng.integers(0, 500, n).astype(np.int32),
    )


def _assert_equal(store: tr.CorrStore, jstore):
    want = fields_np(jstore)
    for name, w in want.items():
        got = getattr(store, name).numpy()
        assert got.dtype == w.dtype, name
        np.testing.assert_array_equal(got, w, err_msg=name)


@pytest.fixture()
def stores():
    """Both stores after three appends; the third overflows the capacity."""
    rng = np.random.default_rng(0)
    js, ts = jr.create_corr_store(CAP), tr.create_corr_store(CAP, "cpu")
    _assert_equal(ts, js)
    for n in (30, 40, 50):
        b = _batch(rng, n)
        js = jr.append_corrs(js, *(jnp.asarray(b[k]) for k in b))
        out = tr.append_corrs(ts, *(t(b[k]) for k in b))
        assert out is ts
        _assert_equal(ts, js)
    return js, ts


def test_append_with_overflow(stores):
    js, ts = stores
    assert int(ts.count) == CAP and int(ts.valid_mask().sum()) == CAP


def test_append_without_key_ids():
    rng = np.random.default_rng(1)
    b = _batch(rng, 20)
    args = [b[k] for k in ("img_i", "img_j", "p_i", "p_j", "valid")]
    js = jr.append_corrs(jr.create_corr_store(CAP), *(jnp.asarray(a) for a in args))
    ts = tr.append_corrs(tr.create_corr_store(CAP, "cpu"), *(t(a) for a in args))
    _assert_equal(ts, js)
    assert 0 < int(ts.count) < 20


def test_invalidate_and_counts(stores):
    js, ts = stores
    js = jr.invalidate_image_pair(js, 1, 2)
    tr.invalidate_image_pair(ts, 1, 2)
    _assert_equal(ts, js)
    js = jr.invalidate_frame(js, 4)
    tr.invalidate_frame(ts, 4)
    _assert_equal(ts, js)
    assert int(ts.valid_mask().sum()) < CAP
    for num_frames in (6, 4):     # 4: frames 4 and 5 fall outside and are dropped
        np.testing.assert_array_equal(tr.corr_counts_per_frame(ts, num_frames).numpy(),
                                      np.asarray(jr.corr_counts_per_frame(js, num_frames)))
    assert int(tr.corr_counts_per_frame(ts, 6)[4]) == 0


def test_compact(stores):
    js, ts = stores
    js = jr.invalidate_frame(js, 0)
    tr.invalidate_frame(ts, 0)
    js = jr.compact_corrs(js)
    tr.compact_corrs(ts)
    _assert_equal(ts, js)
    n = int(ts.count)
    assert 0 < n < CAP and bool(ts.valid_mask()[:n].all()) and not bool(ts.valid_mask()[n:].any())
    # room again: an append lands at the new cursor
    b = _batch(np.random.default_rng(2), 10, p_valid=1.0)
    js = jr.append_corrs(js, *(jnp.asarray(b[k]) for k in b))
    tr.append_corrs(ts, *(t(b[k]) for k in b))
    _assert_equal(ts, js)


def test_from_numpy_round_trip(stores):
    js, _ = stores
    _assert_equal(tr.corr_store_from_numpy(fields_np(js), "cpu"), js)
