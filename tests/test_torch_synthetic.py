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


def test_room_scene_keeps_the_objects_and_closes_the_walls():
    """The port's walled room (no JAX counterpart): inside the room the
    default scene's objects render as before; every ray from a pan pose
    ends on a surface, the farthest a corner within the sensor's 4 m; a
    point near a wall is as far from the scene as from that wall."""
    room, plain = tsyn.room_scene("cpu"), tsyn.default_scene("cpu")
    intr = CameraIntrinsics(**jsyn.default_intrinsics(80, 60).__dict__)
    d_room, _ = tsyn.render_frame(room, intr, torch.from_numpy(tsyn.pan_trajectory(4)[0]))
    d_plain, _ = tsyn.render_frame(plain, intr, torch.from_numpy(tsyn.pan_trajectory(4)[0]))
    objects = torch.isfinite(d_plain) & (d_plain < 2.5)
    assert objects.float().mean() > 0.3
    torch.testing.assert_close(d_room[objects], d_plain[objects], rtol=0, atol=DEPTH_ATOL)
    for pose in tsyn.pan_trajectory(8):
        d, _ = tsyn.render_frame(room, intr, torch.from_numpy(pose))
        # a ray grazing a silhouette may not converge in 64 steps
        assert torch.isfinite(d).float().mean() > 0.99
        assert float(d[torch.isfinite(d)].max()) < 4.0
    p = torch.tensor([[2.1, -0.3, 0.0], [0.0, -1.5, 0.0]])
    torch.testing.assert_close(tsyn.scene_sdf(room, p), torch.tensor([0.1, 0.1]),
                               rtol=0, atol=1e-6)


def test_pan_trajectory_turns_on_the_spot():
    poses = tsyn.pan_trajectory(120)
    R = poses[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-6)
    np.testing.assert_array_equal(poses[:, :3, 3], np.broadcast_to(poses[0, :3, 3], (120, 3)))
    np.testing.assert_allclose(R[0], np.diag([-1.0, -1.0, 1.0]), atol=1e-7)
    fwd = R[:, :, 2]
    yaw = np.unwrap(np.arctan2(fwd[:, 0], fwd[:, 2]))
    assert yaw[-1] - yaw[0] > 2 * np.pi * 0.98 and (np.diff(yaw) > 0).all()
    assert fwd[:, 1].min() < -0.45 and fwd[:, 1].max() > 0.45   # up and down (y down)
