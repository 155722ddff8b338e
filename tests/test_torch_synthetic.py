"""Port synthetic sequence generator against JAX.

The sphere tracer runs 64 steps in float32 on both sides, in another
operation order (XLA fuses and contracts the SDF into FMAs), so a ray that
grazes a silhouette may stop on one side and miss on the other: hit masks
may differ at up to 0.1 % of the pixels, and depth at common hits agrees
within 1e-4 m. Colour follows the hit point: its finest texture term,
0.1 sin(113 (x + y + z)), moves by about 1e-3 per 1e-4 m, so colour at
common hits agrees within 5e-3. Trajectories and intrinsics are numpy on
both sides and equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.io import synthetic as jsyn
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.io import synthetic as tsyn

MAX_MASK_DIFF = 1e-3
DEPTH_ATOL = 1e-4
COLOR_ATOL = 5e-3


def _poses():
    return np.concatenate([jsyn.orbit_trajectory(6)[[0, 3, 5]], jsyn.loop_trajectory(9)[[4]]])


@pytest.mark.parametrize("idx", range(4))
def test_render_frame_matches(idx):
    intr = jsyn.default_intrinsics(160, 120)
    pose = _poses()[idx]
    jd, jc = (np.asarray(a) for a in jsyn.render_frame(jsyn.default_scene(), intr,
                                                       jnp.asarray(pose)))
    td, tc = tsyn.render_frame(tsyn.default_scene("cpu"), CameraIntrinsics(**intr.__dict__),
                               torch.from_numpy(pose))
    td, tc = td.numpy(), tc.numpy()
    assert td.shape == jd.shape and tc.shape == jc.shape
    hit_j, hit_t = np.isfinite(jd), np.isfinite(td)
    assert hit_j.mean() > 0.3
    assert (hit_j != hit_t).mean() <= MAX_MASK_DIFF
    both = hit_j & hit_t
    np.testing.assert_allclose(td[both], jd[both], rtol=0, atol=DEPTH_ATOL)
    np.testing.assert_allclose(tc[both], jc[both], rtol=0, atol=COLOR_ATOL)
    np.testing.assert_array_equal(tc[~hit_t], 0.0)


def test_trajectories_and_intrinsics_equal():
    for n, noise in ((1, 0.0), (12, 0.0), (12, 0.01)):
        np.testing.assert_array_equal(tsyn.orbit_trajectory(n, noise=noise),
                                      jsyn.orbit_trajectory(n, noise=noise))
        np.testing.assert_array_equal(tsyn.loop_trajectory(n, odom_noise=noise),
                                      jsyn.loop_trajectory(n, odom_noise=noise))
        for loops in (1, 3):
            np.testing.assert_array_equal(
                tsyn.multiloop_trajectory(n, n_loops=loops, odom_noise=noise),
                jsyn.multiloop_trajectory(n, n_loops=loops, odom_noise=noise))
    for w, h in ((640, 480), (160, 120)):
        assert tsyn.default_intrinsics(w, h).__dict__ == jsyn.default_intrinsics(w, h).__dict__


def test_make_sequence_wire_matches():
    intr = jsyn.default_intrinsics(80, 60)
    j = jsyn.make_sequence_wire(3, intr=intr, blackout=(1, 2))
    t = tsyn.make_sequence_wire(3, intr=CameraIntrinsics(**intr.__dict__), blackout=(1, 2))
    assert t["depth"].dtype == np.uint16 and t["color"].dtype == np.uint8
    np.testing.assert_array_equal(t["poses"], j["poses"])
    assert not t["depth"][1].any() and not t["color"][1].any()
    jd, td = j["depth"].astype(np.int64), t["depth"].astype(np.int64)
    assert ((jd > 0) != (td > 0)).mean() <= MAX_MASK_DIFF
    both = (jd > 0) & (td > 0)
    # float depth within 1e-4 m can round to the neighbouring mm code
    assert np.abs(jd - td)[both].max() <= 1
    assert np.abs(j["color"].astype(int) - t["color"].astype(int))[both].max() <= 1
