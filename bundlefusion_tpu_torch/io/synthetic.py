"""Synthetic RGB-D sequences from an analytic SDF scene.

Port of ``bundlefusion_tpu/io/synthetic.py:25-350``: the room-like scene
(spheres + boxes + floor) is sphere-traced in torch on the caller's
device; the camera trajectories and intrinsics are numpy copies. Lets the
port run and bench with no JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.lie import pose_to_matrix


@dataclass
class Scene:
    sphere_centers: torch.Tensor  # [S, 3]
    sphere_radii: torch.Tensor    # [S]
    box_centers: torch.Tensor     # [B, 3]
    box_halfsizes: torch.Tensor   # [B, 3]
    floor_y: float                # y of the floor plane (+y is down)


def default_scene(device="cpu") -> Scene:
    """Floor + furniture-ish boxes + spheres in front of the origin."""

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return Scene(
        sphere_centers=f32([[0.35, 0.0, 1.9], [-0.5, 0.25, 2.3], [0.1, -0.35, 1.5]]),
        sphere_radii=f32([0.3, 0.22, 0.15]),
        box_centers=f32([[-0.45, -0.3, 1.8], [0.7, 0.35, 2.6], [0.0, 0.65, 2.2]]),
        box_halfsizes=f32([[0.25, 0.25, 0.25], [0.3, 0.2, 0.3], [0.9, 0.05, 0.8]]),
        floor_y=0.85,
    )


def _object_distances(scene: Scene, p):
    d_sph = torch.linalg.norm(p[..., None, :] - scene.sphere_centers, dim=-1) - scene.sphere_radii
    q = torch.abs(p[..., None, :] - scene.box_centers) - scene.box_halfsizes
    d_box = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
        torch.amax(q, dim=-1), max=0.0
    )
    d_floor = (scene.floor_y - p[..., 1])[..., None]
    return torch.cat([d_sph, d_box, d_floor], -1)


def scene_sdf(scene: Scene, p):
    """Signed distance at world points [..., 3]."""
    return torch.amin(_object_distances(scene, p), dim=-1)


def scene_color(scene: Scene, p):
    """Per-object hue times a high-frequency texture (SIFT needs gradients)."""
    dists = _object_distances(scene, p)
    obj = torch.argmin(dists, dim=-1)
    hues = torch.linspace(0.05, 0.95, dists.shape[-1], dtype=torch.float32, device=p.device)
    hue = hues[obj]
    base = torch.stack([hue, 0.5 + 0.5 * torch.cos(6.28 * hue), 1.0 - hue], -1)
    tex = (
        0.5
        + 0.22 * torch.sin(37.0 * p[..., 0]) * torch.sin(41.0 * p[..., 1])
        + 0.18 * torch.sin(29.0 * p[..., 2] + 3.0 * p[..., 0])
        + 0.1 * torch.sin(113.0 * (p[..., 0] + p[..., 1] + p[..., 2]))
    )
    return torch.clamp(base * tex[..., None] + 0.15, 0.0, 1.0)


def render_frame(scene: Scene, intr: CameraIntrinsics, cam_to_world, n_steps: int = 64):
    """Sphere-trace GT (depth [H, W], color [H, W, 3]) from a camera pose
    (nan depth and black colour where no surface is hit)."""
    dev = scene.sphere_centers.device
    cam_to_world = torch.as_tensor(cam_to_world, dtype=torch.float32, device=dev)
    H, W = intr.height, intr.width
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    dirs_cam = torch.stack(
        [(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, torch.ones_like(u)], -1
    )
    dn = dirs_cam / torch.linalg.norm(dirs_cam, dim=-1, keepdim=True)
    origin = cam_to_world[:3, 3]
    dirs_world = dn @ cam_to_world[:3, :3].T

    t = torch.full((H, W), 0.05, dtype=torch.float32, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        d = scene_sdf(scene, origin + t[..., None] * dirs_world)
        done = done | (d < 1e-4)
        t = torch.where(done, t, t + torch.clamp(d, min=1e-4))
    hit = done & (t < 12.0)
    p = origin + t[..., None] * dirs_world
    color = scene_color(scene, p)
    eps = 1e-3
    grad = []
    for axis in range(3):
        e = torch.zeros(3, dtype=torch.float32, device=dev)
        e[axis] = eps
        grad.append(scene_sdf(scene, p + e) - scene_sdf(scene, p - e))
    n = torch.stack(grad, -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    light = torch.tensor([0.3, -0.8, -0.52], dtype=torch.float32, device=dev)
    shade = 0.6 + 0.4 * torch.clamp(torch.sum(n * light, -1), 0, 1)
    color = color * shade[..., None]
    depth = torch.where(hit, t * dn[..., 2], torch.nan)
    color = torch.where(hit[..., None], color, 0.0)
    return depth, color


def _look_at(eye: np.ndarray) -> np.ndarray:
    target = np.array([0.0, 0.0, 2.0])
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])  # y-down camera
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    return np.stack([right, up2, fwd], 1)


def orbit_trajectory(n_frames: int, radius: float = 0.4, noise: float = 0.0, seed: int = 0):
    """Slight orbit + bob looking at the scene: [N, 4, 4] cam-to-world
    (float32 numpy); ``noise`` jitters each camera centre (meters)."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / max(n_frames, 1) * 0.25  # quarter orbit
        eye = np.array(
            [radius * np.sin(a), 0.1 * np.sin(2.5 * a), -0.2 + 0.15 * np.cos(a) - 0.15],
            np.float64,
        )
        R = _look_at(eye)
        if noise > 0:
            eye = eye + rng.normal(scale=noise, size=3)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = eye
        poses.append(T)
    return np.stack(poses)


def loop_trajectory(n_frames: int, radius: float = 0.55, seed: int = 0,
                    odom_noise: float = 0.0):
    """Out-and-back excursion that returns to (nearly) the start pose."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        a = np.pi / 2.0 * np.sin(np.pi * s) ** 2
        eye = np.array(
            [
                radius * np.sin(a),
                0.12 * np.sin(4.0 * np.pi * s),
                -0.35 + 0.2 * (1.0 - np.cos(a)),
            ],
            np.float64,
        )
        if odom_noise > 0:
            eye = eye + rng.normal(scale=odom_noise, size=3)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _look_at(eye)
        T[:3, 3] = eye
        poses.append(T)
    return np.stack(poses)


def default_intrinsics(width: int = 320, height: int = 240) -> CameraIntrinsics:
    f = 0.89 * width  # ~58 deg hfov like Kinect
    return CameraIntrinsics(
        fx=f, fy=f, cx=(width - 1) / 2.0, cy=(height - 1) / 2.0, width=width, height=height
    )


def make_sequence(n_frames: int, intr: CameraIntrinsics | None = None,
                  scene: Scene | None = None, noise_depth: float = 0.0, seed: int = 0,
                  device="cpu"):
    """Render a synthetic RGB-D sequence along ``orbit_trajectory``.
    Returns numpy depth [N, H, W], color [N, H, W, 3], poses, intrinsics."""
    intr = intr or default_intrinsics()
    scene = scene or default_scene(device)
    poses = orbit_trajectory(n_frames)
    rng = np.random.default_rng(seed)
    depths, colors = [], []
    for i in range(n_frames):
        d, c = render_frame(scene, intr, poses[i])
        d = d.cpu().numpy()
        if noise_depth > 0:
            d = d + rng.normal(scale=noise_depth, size=d.shape).astype(np.float32) * d
        depths.append(d)
        colors.append(c.cpu().numpy())
    return {
        "depth": np.stack(depths),
        "color": np.stack(colors),
        "poses": poses,
        "intrinsics": intr,
    }


def make_sequence_wire(n_frames: int, intr: CameraIntrinsics | None = None,
                       scene: Scene | None = None, poses: np.ndarray | None = None,
                       noise_depth: float = 0.0, blackout: tuple | None = None,
                       seed: int = 0, device="cpu"):
    """Render straight to the wire format (uint16 mm depth / uint8 color).
    ``blackout`` = (start, end) frames left empty (forces tracking loss)."""
    intr = intr or default_intrinsics()
    scene = scene or default_scene(device)
    if poses is None:
        poses = orbit_trajectory(n_frames)
    rng = np.random.default_rng(seed)
    depths = np.zeros((n_frames, intr.height, intr.width), np.uint16)
    colors = np.zeros((n_frames, intr.height, intr.width, 3), np.uint8)
    for i in range(n_frames):
        if blackout is not None and blackout[0] <= i < blackout[1]:
            continue
        d, c = render_frame(scene, intr, poses[i])
        d = d.cpu().numpy()
        if noise_depth > 0:
            d = d + rng.normal(scale=noise_depth, size=d.shape).astype(np.float32) * d
        d = np.where(np.isfinite(d), d, 0.0)
        depths[i] = np.clip(d * 1000.0 + 0.5, 0, 65535).astype(np.uint16)
        colors[i] = np.clip(c.cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return {"depth": depths, "color": colors, "poses": poses, "intrinsics": intr}


def ring_pose_graph(n_frames: int, corrs_per_pair: int = 16, reach: int = 3, seed: int = 0):
    """A pose graph for the solver at width: a slow arc of ``n_frames``
    poses, every frame tied to its ``reach`` predecessors by
    ``corrs_per_pair`` exact 3D-3D correspondences of random world points.

    Returns (gt_poses [N, 6] float32 as [omega, t], arrays): ``arrays`` holds
    the correspondence store's fields as numpy (``img_i`` > ``img_j``, sorted
    by reach then frame), as ``solver.residuals.corr_store_from_numpy`` takes
    them."""
    rng = np.random.default_rng(seed)
    gt_poses = np.zeros((n_frames, 6), np.float32)
    t = np.arange(n_frames, dtype=np.float32)
    gt_poses[:, 1] = 0.002 * t                     # slow yaw
    gt_poses[:, 3] = 0.05 * np.sin(0.05 * t)
    gt_poses[:, 4] = 0.02 * t / n_frames
    gt_poses[:, 5] = 0.05 * np.cos(0.05 * t)
    mats = pose_to_matrix(torch.from_numpy(gt_poses)).numpy()

    pairs = np.concatenate([np.stack([np.arange(d, n_frames), np.arange(d, n_frames) - d], -1)
                            for d in range(1, reach + 1)])          # [P, 2] (i > j)
    world = rng.uniform(-1, 1, size=(len(pairs), corrs_per_pair, 3)).astype(np.float32)
    world[..., 2] += 2.0
    Ti_inv = np.linalg.inv(mats[pairs[:, 0]])
    Tj_inv = np.linalg.inv(mats[pairs[:, 1]])
    p_i = np.einsum("pab,pcb->pca", Ti_inv[:, :3, :3], world) + Ti_inv[:, None, :3, 3]
    p_j = np.einsum("pab,pcb->pca", Tj_inv[:, :3, :3], world) + Tj_inv[:, None, :3, 3]
    C = len(pairs) * corrs_per_pair
    arrays = {
        "img_i": np.repeat(pairs[:, 0], corrs_per_pair).astype(np.int32),
        "img_j": np.repeat(pairs[:, 1], corrs_per_pair).astype(np.int32),
        "p_i": p_i.reshape(C, 3).astype(np.float32),
        "p_j": p_j.reshape(C, 3).astype(np.float32),
        "key_i": np.zeros(C, np.int32),
        "key_j": np.zeros(C, np.int32),
        "count": np.asarray(C, np.int32),
    }
    return gt_poses, arrays
