"""The port's Kabsch fits against the JAX package on seeded point sets,
with zero weights and NaN points: transforms atol 1e-5, eigenvalues rtol
1e-5; the batched form equals a loop over the unbatched one."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu_torch.geometry import kabsch as tk

# the JAX package's geometry/__init__ re-exports the function under the
# module's name, so the module is fetched by its path
jk = importlib.import_module("bundlefusion_tpu.geometry.kabsch")

T_ATOL = 1e-5
EV_RTOL = 1e-5


def _case(seed, n=24, nan_pts=2, zero_w=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.3, size=3)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    src = rng.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 3.0], size=(n, 3))
    dst = src @ R.T + rng.normal(scale=0.3, size=3) + rng.normal(scale=2e-3, size=(n, 3))
    weights = rng.uniform(0.5, 1.5, size=n)
    weights[rng.choice(n, zero_w, replace=False)] = 0.0
    src[rng.choice(n, nan_pts, replace=False)] = np.nan
    return src.astype(np.float32), dst.astype(np.float32), weights.astype(np.float32)


@pytest.mark.parametrize("fit", ["kabsch", "kabsch_fast"])
@pytest.mark.parametrize("seed", range(3))
def test_fit_matches_jax(fit, seed):
    src, dst, w = _case(seed)
    T, r2 = getattr(tk, fit)(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    jT, jr2 = getattr(jk, fit)(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(float(r2), float(jr2), rtol=1e-3, atol=1e-9)
    R = T[:3, :3].numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(R) > 0


def test_kabsch_without_weights():
    src, dst, _ = _case(7, nan_pts=0)
    T, _ = tk.kabsch(torch.from_numpy(src), torch.from_numpy(dst))
    jT, _ = jk.kabsch(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=T_ATOL)


@pytest.mark.parametrize("fit", ["kabsch", "kabsch_fast"])
def test_batched_fit_equals_loop(fit):
    cases = [_case(s) for s in range(4)]
    src, dst, w = (torch.from_numpy(np.stack(x)) for x in zip(*cases))
    T, r2 = getattr(tk, fit)(src, dst, w)
    assert T.shape == (4, 4, 4) and r2.shape == (4,)
    for b in range(4):
        Tb, rb = getattr(tk, fit)(src[b], dst[b], w[b])
        np.testing.assert_allclose(T[b].numpy(), Tb.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(r2[b]), float(rb), rtol=1e-4)


def test_sym3_eigenvalues():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(16, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    A[0] = np.diag([1.0, 1.0, 2.0])   # a repeated eigenvalue
    got = tk.sym3_eigenvalues(torch.from_numpy(A)).numpy()
    want = np.asarray(jk.sym3_eigenvalues(jnp.asarray(A)))
    np.testing.assert_allclose(got, want, rtol=EV_RTOL, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.eigvalsh(A.astype(np.float64)), rtol=1e-3,
                               atol=1e-4)


def test_kabsch_condition():
    rng = np.random.default_rng(1)
    blob = rng.normal(size=(20, 3)).astype(np.float32)
    line = (np.linspace(0, 1, 20)[:, None] * np.array([[1.0, 2.0, 0.5]])
            + rng.normal(scale=1e-4, size=(20, 3))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=20).astype(np.float32)
    for pts, expect in ((blob, True), (line, False)):
        ratio, ok = tk.kabsch_condition(torch.from_numpy(pts), torch.from_numpy(w))
        jratio, jok = jk.kabsch_condition(jnp.asarray(pts), jnp.asarray(w))
        assert bool(ok) == bool(jok) == expect
        if expect:
            np.testing.assert_allclose(float(ratio), float(jratio), rtol=1e-3)
    ratio, ok = tk.kabsch_condition(torch.from_numpy(np.stack([blob, line])))
    assert ok.tolist() == [True, False]
