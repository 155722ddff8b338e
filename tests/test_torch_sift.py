"""The port's SIFT against the JAX package, stage by stage so that a
threshold flip upstream cannot hide a fault downstream: ``build_pyramid``
atol 1e-5; ``_detect_octave`` fed the JAX DoG stack: the valid candidate
sets equal; ``_orientations`` and ``_descriptors`` fed the JAX keys and
gradient bank: angles atol 1e-4, descriptors atol 1e-4; then
``detect_and_describe`` whole on three synthetic frames: at least 95 % of
the valid keys of either side have a partner within 0.5 px and the same
scale on the other, and partners' descriptors have cosine above 0.99.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.ops import sift as jsift
from bundlefusion_tpu_torch.ops import sift as tsift
from tests.torch_parity import SIFT, sift_inputs, t, to_np

PYR_ATOL = 1e-5
ANG_ATOL = 1e-4
DESC_ATOL = 1e-4
N_FRAMES = 3


@pytest.fixture(scope="module")
def frames():
    inten, depth, _, _ = sift_inputs(N_FRAMES)
    return inten, depth


@pytest.fixture(scope="module")
def jax_pyramids(frames):
    cfg = jsift.SiftConfig(**SIFT)
    return [jsift.build_pyramid(jnp.asarray(i), cfg) for i in frames[0]]


def test_config_defaults_match():
    assert tsift.SiftConfig().__dict__ == jsift.SiftConfig().__dict__
    assert tsift.SiftConfig(**jsift.SiftConfig(**SIFT).__dict__).__dict__ == \
        jsift.SiftConfig(**SIFT).__dict__


def test_build_pyramid(frames, jax_pyramids):
    cfg = tsift.SiftConfig(**SIFT)
    for f in range(N_FRAMES):
        got = tsift.build_pyramid(t(frames[0][f]), cfg)
        assert len(got) == cfg.num_octaves
        for g, j in zip(got, jax_pyramids[f]):
            for name in ("gauss", "dog"):
                np.testing.assert_allclose(g[name].numpy(), to_np(j[name]), rtol=0,
                                           atol=PYR_ATOL)


def test_detect_octave_on_jax_dog(jax_pyramids):
    cfg, jcfg = tsift.SiftConfig(**SIFT), jsift.SiftConfig(**SIFT)
    total = 0
    for pyr in jax_pyramids:
        for o, octv in enumerate(pyr):
            jx, jy, js, jr, jv = (to_np(a) for a in jsift._detect_octave(octv["dog"], jcfg, o))
            tx, ty, ts, tr, tv = (a.numpy() for a in
                                  tsift._detect_octave(t(to_np(octv["dog"])), cfg, o))
            want = {(x, y, s) for x, y, s in zip(jx[jv], jy[jv], js[jv])}
            got = {(x, y, s) for x, y, s in zip(tx[tv], ty[tv], ts[tv])}
            assert got == want
            np.testing.assert_array_equal(np.sort(tr[tv]), np.sort(jr[jv]))
            total += len(want)
    assert total > 100


@pytest.fixture(scope="module")
def jax_keys_and_bank(frames, jax_pyramids):
    """Per frame: the JAX keys and the JAX gradient bank, laid out as
    ``detect_and_describe`` lays it out (levels 1..S of each octave)."""
    cfg = jsift.SiftConfig(**SIFT)
    S = cfg.scales_per_octave
    out = []
    for f in range(N_FRAMES):
        kp = jsift.detect_and_describe(jnp.asarray(frames[0][f]), jnp.asarray(frames[1][f]), cfg)
        gm, go, shapes = [], [], []
        for octv in jax_pyramids[f]:
            shapes.append(tuple(octv["gauss"].shape[1:]))
            for s in range(1, S + 1):
                g = octv["gauss"][s]
                dgx = 0.5 * (jnp.roll(g, -1, 1) - jnp.roll(g, 1, 1))
                dgy = 0.5 * (jnp.roll(g, -1, 0) - jnp.roll(g, 1, 0))
                gm.append(jnp.sqrt(dgx * dgx + dgy * dgy).reshape(-1))
                go.append((jnp.arctan2(dgy, dgx) % (2 * jnp.pi)).reshape(-1))
        out.append((kp, to_np(jnp.concatenate(gm)), to_np(jnp.concatenate(go)), tuple(shapes)))
    return out


def _key_levels(kp, cfg):
    """(octave, scale index, local x, local y, local sigma) of each key,
    recovered from its full-res scale as ``detect_and_describe`` made it."""
    S = cfg.scales_per_octave
    lev = np.round(np.log2(to_np(kp.scale) / cfg.sigma0) * S).astype(np.int64)
    # level = S * octave + scale index with scale index in 1..S
    octave = (lev - 1) // S
    sidx = lev - S * octave
    mul = 2.0 ** octave
    return octave, sidx, to_np(kp.pos)[:, 0] / mul, to_np(kp.pos)[:, 1] / mul, \
        cfg.sigma0 * 2.0 ** (sidx / S)


def test_gradient_bank(frames, jax_keys_and_bank):
    cfg = tsift.SiftConfig(**SIFT)
    pyr = tsift.build_pyramid(t(frames[0][0]), cfg)
    gm, go = tsift._gradient_bank(pyr, cfg)
    _, jgm, jgo, _ = jax_keys_and_bank[0]
    np.testing.assert_allclose(gm.numpy(), jgm, rtol=0, atol=1e-5)
    # orientation where there is a gradient to speak of (atan2 of two
    # rounding residues is arbitrary), modulo 2 pi
    strong = jgm > 1e-3
    d = np.abs(go.numpy() - jgo)[strong]
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-3


def test_orientations_and_descriptors_on_jax_keys(jax_keys_and_bank):
    cfg = tsift.SiftConfig(**SIFT)
    S = cfg.scales_per_octave
    n_valid = 0
    ang_err = []
    for kp, gm, go, shapes in jax_keys_and_bank:
        octave, sidx, lx, ly, sig = _key_levels(kp, cfg)
        valid = to_np(kp.valid)
        octave = np.where(valid, octave, 0)
        sidx = np.where(valid, sidx, 1)
        base_all, W_all, H_all = tsift._bank_layout(shapes, S, torch.device("cpu"))
        ko = t(octave)
        args = (t(gm), t(go), base_all[ko * (S + 1) + t(sidx)], W_all[ko], H_all[ko],
                t(lx.astype(np.float32)), t(ly.astype(np.float32)), t(sig.astype(np.float32)))
        ang = tsift._orientations(*args)
        jang = to_np(kp.orientation)
        d = np.abs(ang.numpy() - jang)[valid]
        d = np.minimum(d, 2 * np.pi - d)
        # a sample whose interpolated gradient direction lies within an ulp
        # of a histogram bin edge may fall into the next bin on one side
        # (XLA contracts the interpolation into FMAs); its weight then moves
        # the peak's parabola a little. Such keys are few and move little.
        ang_err.append(d)
        desc = tsift._descriptors(*args, t(jang))
        np.testing.assert_allclose(desc.numpy()[valid], to_np(kp.desc)[valid], rtol=0,
                                   atol=DESC_ATOL)
        n_valid += int(valid.sum())
    assert n_valid > 100
    ang_err = np.concatenate(ang_err)
    off = ang_err >= ANG_ATOL
    assert off.mean() <= 0.02 and ang_err.max() < 5e-3, (off.sum(), ang_err.max())


def _partners(a, b):
    """For each valid key of a: does b hold a valid key within 0.5 px with
    the same scale, and the cosine of the two descriptors."""
    pa, pb = a["pos"][a["valid"]], b["pos"][b["valid"]]
    dist = np.linalg.norm(pa[:, None] - pb[None], axis=-1)
    same = np.isclose(a["scale"][a["valid"]][:, None], b["scale"][b["valid"]][None], rtol=1e-5)
    dist = np.where(same, dist, np.inf)
    j = dist.argmin(1)
    has = dist[np.arange(len(pa)), j] <= 0.5
    cos = (a["desc"][a["valid"]] * b["desc"][b["valid"]][j]).sum(-1)
    return has, cos


def test_detect_and_describe_whole(frames, jax_keys_and_bank):
    cfg = tsift.SiftConfig(**SIFT)
    for f in range(N_FRAMES):
        kp = tsift.detect_and_describe(t(frames[0][f]), t(frames[1][f]), cfg)
        got = {k: v.numpy() for k, v in kp._asdict().items()}
        want = {k: to_np(v) for k, v in jax_keys_and_bank[f][0]._asdict().items()}
        assert got["desc"].shape == (cfg.target_keys, 128)
        assert got["valid"].sum() > 30
        # invalid keys carry zero descriptors; valid ones are unit vectors
        assert not got["desc"][~got["valid"]].any()
        np.testing.assert_allclose(np.linalg.norm(got["desc"][got["valid"]], axis=1), 1.0,
                                   atol=1e-5)
        for a, b in ((got, want), (want, got)):
            has, cos = _partners(a, b)
            assert has.mean() >= 0.95, has.mean()
            assert (cos[has] > 0.99).all(), cos[has].min()
        # partners also agree on depth and response
        has, _ = _partners(got, want)
        assert np.isfinite(got["depth"][got["valid"]]).all()


def test_invalid_depth_yields_no_keys(frames):
    cfg = tsift.SiftConfig(**SIFT)
    kp = tsift.detect_and_describe(t(frames[0][0]), torch.full((120, 160), torch.nan), cfg)
    assert not kp.valid.any() and not kp.desc.any()
