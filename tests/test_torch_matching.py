"""The port's descriptor matching against the JAX package on the JAX
descriptors of four synthetic frames: ``idx_i``, ``idx_j``, ``valid`` equal
under ``valid``, ``dist`` atol 1e-5; and a case with fewer keys than
``num_matches`` (the padding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.ops import matching as jm
from bundlefusion_tpu_torch.ops import matching as tm
from tests.torch_parity import fields_np, jax_window, t

DIST_ATOL = 1e-5


@pytest.fixture(scope="module")
def window():
    keys, _, _, _ = jax_window(4, 4)
    return keys


def _assert_same(got: tm.PairMatches, want):
    want = fields_np(want)
    v = want["valid"]
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum() > 0
    np.testing.assert_array_equal(got.idx_i.numpy()[v], want["idx_i"][v])
    np.testing.assert_array_equal(got.idx_j.numpy()[v], want["idx_j"][v])
    np.testing.assert_allclose(got.dist.numpy()[v], want["dist"][v], rtol=0, atol=DIST_ATOL)
    # valid entries are a prefix, sorted by distance
    d = got.dist.numpy()
    assert (np.diff(d, axis=-1) >= 0).all()
    assert (np.diff(got.valid.numpy().astype(int), axis=-1) <= 0).all()


def test_match_current_against_previous(window):
    k = fields_np(window)
    active = np.array([True, True, False])
    want = jm.match_current_against_previous(
        window.desc[3].astype(jnp.float32), window.valid[3],
        window.desc[:3].astype(jnp.float32), window.valid[:3], jnp.asarray(active))
    got = tm.match_current_against_previous(
        t(k["desc"][3]), t(k["valid"][3]), t(k["desc"][:3]), t(k["valid"][:3]), t(active))
    assert got.idx_i.shape == (3, 128)
    _assert_same(got, want)
    assert not got.valid[2].any() and int(got.valid[1].sum()) > 10


@pytest.mark.parametrize("num_matches", [128, 32])
def test_match_pair(window, num_matches):
    """128 > 96 keys: padded; 32 < 96: truncated to the best."""
    k = fields_np(window)
    want = jm.match_descriptors_pair(
        window.desc[1].astype(jnp.float32), window.valid[1],
        window.desc[0].astype(jnp.float32), window.valid[0], 0.7, 0.8, num_matches)
    got = tm.match_descriptors_pair(t(k["desc"][1]), t(k["valid"][1]), t(k["desc"][0]),
                                    t(k["valid"][0]), 0.7, 0.8, num_matches)
    assert got.dist.shape == (num_matches,)
    _assert_same(got, want)
    if num_matches > 96:
        assert (got.dist[96:] == 1e9).all() and not got.valid[96:].any()


def test_ties_keep_the_lower_index():
    """Two identical keys on both sides: equal distances; the lower index
    comes first, as ``lax.top_k`` has it."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(6, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    noise = d + 0.01 * rng.normal(size=d.shape).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    valid = np.ones(6, bool)
    want = jm.match_descriptors_pair(jnp.asarray(d), jnp.asarray(valid), jnp.asarray(noise),
                                     jnp.asarray(valid), 0.7, 0.8, 8)
    got = tm.match_descriptors_pair(t(d), t(valid), t(noise), t(valid), 0.7, 0.8, 8)
    _assert_same(got, want)
