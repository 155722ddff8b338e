"""The frontend's image ops, the gather and the samplers against the JAX
package: same seeded inputs through both, atol 1e-6, NaN masks equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.geometry import camera as jcam
from bundlefusion_tpu.ops import image as jimg
from bundlefusion_tpu.ops.resample import onehot_gather2d as jax_gather
from bundlefusion_tpu_torch.geometry import camera as tcam
from bundlefusion_tpu_torch.ops import image as timg
from bundlefusion_tpu_torch.ops.resample import onehot_gather2d

ATOL = 1e-6
INTR = dict(fx=100.0, fy=98.0, cx=31.5, cy=23.5, width=64, height=48)


def _close(got: torch.Tensor, want, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=True)


@pytest.fixture(scope="module")
def depth():
    """A 48x64 depth map with a step edge, a ramp, noise and holes that
    reach the image border (the windows wrap around there)."""
    rng = np.random.default_rng(0)
    d = 1.5 + 0.01 * np.arange(64)[None, :] + 0.005 * np.arange(48)[:, None]
    d[:, 40:] += 0.6
    d = d + rng.normal(scale=0.004, size=d.shape)
    d[rng.random(d.shape) < 0.05] = np.nan
    d[:3, :9] = np.nan
    d[-2:, 50:] = np.nan
    return d.astype(np.float32)


def test_erode_depth(depth):
    _close(timg.erode_depth(torch.from_numpy(depth)), jimg.erode_depth(jnp.asarray(depth)))


@pytest.mark.parametrize("sigma_d,sigma_r", [(2.0, 0.1), (1.0, 0.05)])
def test_bilateral_filter_depth(depth, sigma_d, sigma_r):
    _close(timg.bilateral_filter_depth(torch.from_numpy(depth), sigma_d, sigma_r),
           jimg.bilateral_filter_depth(jnp.asarray(depth), sigma_d, sigma_r))


@pytest.mark.parametrize("channels", [0, 3])
def test_gauss_filter(channels):
    rng = np.random.default_rng(1)
    img = rng.random((48, 64, channels) if channels else (48, 64)).astype(np.float32)
    _close(timg.gauss_filter(torch.from_numpy(img)), jimg.gauss_filter(jnp.asarray(img)))


def test_cam_points_and_normals(depth):
    got = timg.depth_to_cam_points(torch.from_numpy(depth), tcam.CameraIntrinsics(**INTR))
    want = jimg.depth_to_cam_points(jnp.asarray(depth), jcam.CameraIntrinsics(**INTR))
    _close(got, want)
    _close(timg.compute_normals(got), jimg.compute_normals(want))


def test_intensity_derivatives():
    img = np.random.default_rng(2).random((48, 64)).astype(np.float32)
    _close(timg.intensity_derivatives(torch.from_numpy(img)),
           jimg.intensity_derivatives(jnp.asarray(img)))


def test_reproject_depth_to_color(depth):
    d2c = np.eye(4, dtype=np.float32)
    d2c[:3, 3] = [0.02, -0.01, 0.005]
    color = dict(INTR, fx=90.0, fy=90.0)
    got = timg.reproject_depth_to_color(
        torch.from_numpy(depth), tcam.CameraIntrinsics(**INTR), tcam.CameraIntrinsics(**color),
        torch.from_numpy(d2c), fill_passes=2)
    want = np.asarray(jimg.reproject_depth_to_color(
        jnp.asarray(depth), jcam.CameraIntrinsics(**INTR), jcam.CameraIntrinsics(**color),
        jnp.asarray(d2c), fill_passes=2))
    # a projection within an ulp of a pixel edge may land in the next pixel
    same = (np.isnan(got.numpy()) == np.isnan(want)) & np.isclose(
        got.numpy(), want, rtol=0, atol=ATOL, equal_nan=True)
    assert same.mean() > 0.999 and np.isfinite(want).sum() > 1000


def test_onehot_gather2d():
    rng = np.random.default_rng(3)
    stack = rng.normal(size=(5, 30, 40)).astype(np.float32)
    vi = rng.integers(0, 30, size=(7, 11))
    ui = rng.integers(0, 40, size=(7, 11))
    valid = rng.random((7, 11)) < 0.8
    got = onehot_gather2d(torch.from_numpy(stack), torch.from_numpy(vi), torch.from_numpy(ui),
                          torch.from_numpy(valid))
    want = jax_gather(jnp.asarray(stack), jnp.asarray(vi), jnp.asarray(ui), jnp.asarray(valid))
    _close(got, want)
    assert not got.requires_grad
    # the batched form equals a loop over the unbatched one
    stacks = rng.normal(size=(3, 5, 30, 40)).astype(np.float32)
    vb, ub, mb = (np.stack([a] * 3) for a in (vi, ui, valid))
    batched = onehot_gather2d(*(torch.from_numpy(a) for a in (stacks, vb, ub, mb)))
    for b in range(3):
        one = onehot_gather2d(torch.from_numpy(stacks[b]), torch.from_numpy(vi),
                              torch.from_numpy(ui), torch.from_numpy(valid))
        assert torch.equal(batched[b], one)


@pytest.mark.parametrize("channels", [0, 3])
def test_samplers(channels):
    rng = np.random.default_rng(4)
    img = rng.random((30, 40, channels) if channels else (30, 40)).astype(np.float32)
    uv = rng.uniform([-3, -3], [43, 33], size=(200, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [39, 29], [39.0001, 5], [5, -0.0001], [0.5, 0.5], [1.5, 2.5],
              [np.nan, 3], [38.5, 28.5]]
    _close(tcam.bilinear_sample(torch.from_numpy(img), torch.from_numpy(uv)),
           jcam.bilinear_sample(jnp.asarray(img), jnp.asarray(uv)))
    # a nan coordinate: the JAX sampler converts it to an integer, which is
    # undefined; the port returns nan there, so that row is held apart
    got = tcam.nearest_sample(torch.from_numpy(img), torch.from_numpy(uv))
    assert torch.isnan(got[6]).all()
    fin = np.arange(200) != 6
    _close(got[fin], jcam.nearest_sample(jnp.asarray(img), jnp.asarray(uv[fin])))
    tin = tcam.in_bounds(torch.from_numpy(uv), tcam.CameraIntrinsics(**INTR), 1.0)
    jin = jcam.in_bounds(jnp.asarray(uv), jcam.CameraIntrinsics(**INTR), 1.0)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
