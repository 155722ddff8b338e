"""The port's filter cascade against the JAX package, stage by stage on the
same raw matches: inlier masks and ``valid_pair`` equal, transforms atol
1e-4, areas rtol 1e-4, ``err`` / ``corr`` of dense verify atol 1e-5; and the
greedy filter against the numpy oracle of the reference CPU filter on the
cases of ``tests/test_filter_oracle.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.ops import filters as jf
from bundlefusion_tpu.ops.matching import match_descriptors_pair
from bundlefusion_tpu.pipeline.frames import backproject_keys
from bundlefusion_tpu_torch.ops import filters as tf
from tests.oracles.match_filter import filter_matches_oracle
from tests.test_filter_oracle import _make_pair, _rigid
from tests.torch_parity import fields_np, jax_window, port_intr, t, to_np

T_ATOL = 1e-4
AREA_RTOL = 1e-4
DV_ATOL = 1e-5


@pytest.fixture(scope="module")
def window():
    return jax_window(4, 4)


@pytest.fixture(scope="module")
def raw_matches(window):
    """Raw matches of frame 3 against frames 0..2, back-projected (JAX),
    plus a scrambled copy of pair 0 (no rigid motion: must be rejected)
    and an all-invalid pair."""
    keys, _, intr, _ = window
    rows = []
    for s in range(3):
        m = match_descriptors_pair(keys.desc[3].astype(jnp.float32), keys.valid[3],
                                   keys.desc[s].astype(jnp.float32), keys.valid[s])
        pix_c, pix_p = keys.pos[3][m.idx_i], keys.pos[s][m.idx_j]
        rows.append((backproject_keys(pix_c, keys.depth[3][m.idx_i], intr),
                     backproject_keys(pix_p, keys.depth[s][m.idx_j], intr),
                     pix_c, pix_p, m.valid))
    src, tgt, ps, pt, valid = (np.stack([to_np(r[i]) for r in rows]) for i in range(5))
    perm = np.random.default_rng(0).permutation(128)
    src = np.concatenate([src, src[:1], src[:1]])
    tgt = np.concatenate([tgt, tgt[:1, perm], tgt[:1]])
    ps = np.concatenate([ps, ps[:1], ps[:1]])
    pt = np.concatenate([pt, pt[:1, perm], pt[:1]])
    valid = np.concatenate([valid, valid[:1], np.zeros_like(valid[:1])])
    return src, tgt, ps, pt, valid


@pytest.fixture(scope="module")
def jax_kabsch(raw_matches):
    out = jf.kabsch_filter(*(jnp.asarray(a) for a in raw_matches), 25, 4, 4e-4)
    return {k: to_np(v) for k, v in out.items()}


def test_kabsch_filter_matches_jax(raw_matches, jax_kabsch):
    src, tgt, ps, pt, valid = raw_matches
    # the precondition of the early-exit scan
    assert (np.diff(valid.astype(int), axis=1) <= 0).all()
    got = tf.kabsch_filter(*(t(a) for a in raw_matches), 25, 4, 4e-4)
    # at least one read per candidate step, at most three plus the strips
    assert valid.sum(1).min() <= got["host_reads"] <= 4 * 128
    want = jax_kabsch
    np.testing.assert_array_equal(got["valid_pair"].numpy(), want["valid_pair"])
    assert want["valid_pair"].tolist() == [True, True, True, False, False]
    np.testing.assert_array_equal(got["inlier_mask"].numpy(), want["inlier_mask"])
    np.testing.assert_array_equal(got["count"].numpy(), want["count"])
    ok = want["valid_pair"]
    np.testing.assert_allclose(got["transform"].numpy()[ok], want["transform"][ok], rtol=0,
                               atol=T_ATOL)
    # the pairs stop at different steps: they hold different numbers of matches
    assert len(set(valid.sum(1).tolist())) > 2


def test_kabsch_filter_pair_equals_batch(raw_matches):
    batch = tf.kabsch_filter(*(t(a) for a in raw_matches))
    for p in (1, 3):
        one = tf.kabsch_filter_pair(*(t(a[p]) for a in raw_matches))
        assert torch.equal(one["inlier_mask"], batch["inlier_mask"][p])
        assert bool(one["valid_pair"]) == bool(batch["valid_pair"][p])
        np.testing.assert_allclose(one["transform"].numpy(), batch["transform"][p].numpy(),
                                   atol=1e-6)


def test_surface_area_matches_jax(raw_matches, jax_kabsch):
    src, tgt = raw_matches[:2]
    mask = jax_kabsch["inlier_mask"]
    keep, a0, a1 = tf.surface_area_filter(t(src), t(tgt), t(mask), 0.032)
    jkeep, ja0, ja1 = jf.surface_area_filter(jnp.asarray(src), jnp.asarray(tgt),
                                             jnp.asarray(mask), 0.032)
    np.testing.assert_array_equal(keep.numpy(), to_np(jkeep))
    assert to_np(jkeep).tolist() == [True, True, True, False, False]
    np.testing.assert_allclose(a0.numpy(), to_np(ja0), rtol=AREA_RTOL, atol=1e-7)
    np.testing.assert_allclose(a1.numpy(), to_np(ja1), rtol=AREA_RTOL, atol=1e-7)
    one = tf.surface_area_filter_pair(t(src[0]), t(tgt[0]), t(mask[0]), 0.032)
    assert bool(one[0]) and abs(float(one[1]) - float(a0[0])) < 1e-7


def test_surface_area_rejects_a_line():
    pts = np.zeros((1, 16, 3), np.float32)
    pts[0, :, 0] = np.linspace(0, 1, 16)
    pts[0, :, 2] = 2.0
    w = np.ones((1, 16), bool)
    keep, a0, _ = tf.surface_area_filter(t(pts), t(pts), t(w), 0.032)
    jkeep, ja0, _ = jf.surface_area_filter(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(w),
                                           0.032)
    assert not bool(keep[0]) and not bool(jkeep[0])
    assert float(a0[0]) < 0.032 and float(ja0[0]) < 0.032


def test_dense_verify_matches_jax(window, jax_kabsch):
    _, cache, _, intr_cache = window
    c = fields_np(cache)
    T = jax_kabsch["transform"][:3].copy()
    # a wrong transform: fails the error / correspondence thresholds
    T_bad = T[:1].copy()
    T_bad[0, :3, 3] += [0.4, 0.0, 0.3]
    T = np.concatenate([T, T_bad])
    slots = [0, 1, 2, 0]
    assert tf.DenseVerifyParams().__dict__ == jf.DenseVerifyParams().__dict__
    # at this cache size (40x30) a correct transform leaves an error of
    # 0.08-0.11, around the default threshold of 0.075; 0.12 puts the three
    # fitted transforms on one side and the wrong one on the other
    jp = jf.DenseVerifyParams(err_thresh=0.12)
    p = tf.DenseVerifyParams(**jp.__dict__)
    keep, err, corr = tf.dense_verify(
        t(T), t(c["depth"][3]), t(c["campos"][3]), t(c["normal"][3]),
        t(c["depth"][slots]), t(c["campos"][slots]), t(c["normal"][slots]),
        port_intr(intr_cache), p)
    want = [jf.dense_verify_pair(jnp.asarray(T[n]), cache.depth[3], cache.campos[3],
                                 cache.normal[3], cache.depth[s], cache.campos[s],
                                 cache.normal[s], intr_cache, jp)
            for n, s in enumerate(slots)]
    jkeep, jerr, jcorr = (np.array([float(w[i]) for w in want]) for i in range(3))
    np.testing.assert_array_equal(keep.numpy(), jkeep.astype(bool))
    assert jkeep.tolist() == [1, 1, 1, 0]
    # a pixel that projects within an ulp of a pixel edge may associate with
    # the neighbour on one side: one correspondence of 1200 moves corr by
    # 4e-4, so corr is held to a few such pixels and err to their effect
    np.testing.assert_allclose(corr.numpy(), jcorr, rtol=0, atol=DV_ATOL)
    np.testing.assert_allclose(err.numpy(), jerr, rtol=0, atol=DV_ATOL)
    one = tf.dense_verify_pair(t(T[1]), t(c["depth"][3]), t(c["campos"][3]), t(c["normal"][3]),
                               t(c["depth"][1]), t(c["campos"][1]), t(c["normal"][1]),
                               port_intr(intr_cache), p)
    assert bool(one[0]) and abs(float(one[1]) - float(err[1])) < 1e-7


# ---- the greedy filter against the numpy oracle of the reference ----


def _run_port(src, tgt, ps, pt, valid):
    out = tf.kabsch_filter_pair(t(src), t(tgt), t(ps), t(pt), t(valid))
    return {"valid_pair": bool(out["valid_pair"]),
            "inlier_idx": np.where(out["inlier_mask"].numpy())[0],
            "transform": out["transform"].numpy()}


@pytest.mark.parametrize("seed", range(3))
def test_oracle_clean_pair_both_accept(seed):
    rng = np.random.default_rng(seed)
    src, tgt, ps, pt, valid, T_gt, _ = _make_pair(rng, n_in=20, n_out=0)
    got = _run_port(src, tgt, ps, pt, valid)
    orc = filter_matches_oracle(src, tgt, ps, pt, valid)
    assert got["valid_pair"] and orc["valid_pair"]
    assert np.allclose(got["transform"], T_gt, atol=5e-3)
    assert np.allclose(got["transform"], orc["transform"], atol=5e-3)


@pytest.mark.parametrize("seed", range(3))
def test_oracle_outliers_excluded_by_both(seed):
    rng = np.random.default_rng(100 + seed)
    src, tgt, ps, pt, valid, T_gt, out_idx = _make_pair(rng, n_in=16, n_out=5)
    got = _run_port(src, tgt, ps, pt, valid)
    orc = filter_matches_oracle(src, tgt, ps, pt, valid)
    assert got["valid_pair"] and orc["valid_pair"]
    assert not set(out_idx) & set(got["inlier_idx"].tolist())
    assert np.allclose(got["transform"], T_gt, atol=1e-2)


@pytest.mark.parametrize("seed", range(2))
def test_oracle_nonrigid_rejected_by_both(seed):
    rng = np.random.default_rng(200 + seed)
    src, tgt, ps, pt, valid, _, _ = _make_pair(rng, n_in=0, n_out=24)
    assert not _run_port(src, tgt, ps, pt, valid)["valid_pair"]
    assert not filter_matches_oracle(src, tgt, ps, pt, valid)["valid_pair"]


def test_oracle_collinear_rejected_by_both():
    rng = np.random.default_rng(300)
    line = np.linspace(0, 1, 16)[:, None] * rng.normal(size=3) + rng.normal(scale=1e-5,
                                                                            size=(16, 3))
    T = _rigid(rng)
    pad = 128 - 16
    src = np.concatenate([line, np.zeros((pad, 3))]).astype(np.float32)
    tgt = np.concatenate([line @ T[:3, :3].T + T[:3, 3], np.zeros((pad, 3))]).astype(np.float32)
    ps = np.concatenate([np.arange(16)[:, None] * np.array([[17.0, 23.0]]),
                         np.full((pad, 2), 1e6)]).astype(np.float32)
    valid = np.concatenate([np.ones(16, bool), np.zeros(pad, bool)])
    assert not _run_port(src, tgt, ps, ps + 2.0, valid)["valid_pair"]
    assert not filter_matches_oracle(src, tgt, ps, ps + 2.0, valid)["valid_pair"]


def test_batch_of_oracle_cases_matches_jax():
    """Pairs of different kinds in one batch (clean, with outliers, random,
    near-duplicate pixels): every pair as JAX has it alone."""
    cases = [_make_pair(np.random.default_rng(s), n_in=n_in, n_out=n_out)[:5]
             for s, n_in, n_out in ((0, 20, 0), (101, 16, 5), (200, 0, 24), (3, 40, 8))]
    cases[3][2][5] = cases[3][2][2] + 1.0       # within 5 px of an earlier match
    batch = [np.stack([c[i] for c in cases]) for i in range(5)]
    got = tf.kabsch_filter(*(t(a) for a in batch))
    fn = jax.jit(jf.kabsch_filter_pair)
    for p, c in enumerate(cases):
        want = fn(*(jnp.asarray(a) for a in c))
        assert bool(got["valid_pair"][p]) == bool(want["valid_pair"]), p
        np.testing.assert_array_equal(got["inlier_mask"][p].numpy(), to_np(want["inlier_mask"]))
        if bool(want["valid_pair"]):
            np.testing.assert_allclose(got["transform"][p].numpy(), to_np(want["transform"]),
                                       rtol=0, atol=T_ATOL)
    assert got["valid_pair"].tolist() == [True, True, False, True]
    assert int(got["count"][3]) == 25 and not bool(got["inlier_mask"][3, 5])
