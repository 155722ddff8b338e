"""The benchmark's scan generator: seeded RGB-D frames of a synthetic room.

A frozen copy of the port's synthetic renderer (``io/synthetic.py``:
``default_scene``, the scene's signed distance and colour, the sphere
tracer, ``_look_at``, ``orbit_trajectory`` and ``multiloop_trajectory``),
so that a later change to the program cannot move the yardstick. The
tracer here renders a batch of poses in one pass (the same arithmetic per
pixel), on the device it is given.

A traffic file (``traffic/<name>.json``) names the scan, its start and its
noise; the seed draws the camera jitter and the depth noise. Frames are
made in the sensor's wire format: uint16 millimetre depth (0 where nothing
is hit) and uint8 colour, the format ``.sens`` files hold.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TARGET = np.array([0.0, 0.0, 2.0])


class Scene:
    """Floor, three boxes and three spheres in front of the origin (+y is
    down), as ``io/synthetic.py`` ``default_scene``."""

    def __init__(self, device):
        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        self.sphere_centers = f32([[0.35, 0.0, 1.9], [-0.5, 0.25, 2.3], [0.1, -0.35, 1.5]])
        self.sphere_radii = f32([0.3, 0.22, 0.15])
        self.box_centers = f32([[-0.45, -0.3, 1.8], [0.7, 0.35, 2.6], [0.0, 0.65, 2.2]])
        self.box_halfsizes = f32([[0.25, 0.25, 0.25], [0.3, 0.2, 0.3], [0.9, 0.05, 0.8]])
        self.floor_y = 0.85

    def distances(self, p):
        """Per-object signed distances [..., 7] at world points [..., 3]."""
        d_sph = torch.linalg.norm(p[..., None, :] - self.sphere_centers, dim=-1) - self.sphere_radii
        q = torch.abs(p[..., None, :] - self.box_centers) - self.box_halfsizes
        d_box = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
            torch.amax(q, dim=-1), max=0.0)
        d_floor = (self.floor_y - p[..., 1])[..., None]
        return torch.cat([d_sph, d_box, d_floor], -1)

    def sdf(self, p):
        return torch.amin(self.distances(p), dim=-1)

    def color(self, p):
        """Per-object hue times a high-frequency texture."""
        dists = self.distances(p)
        obj = torch.argmin(dists, dim=-1)
        hues = torch.linspace(0.05, 0.95, dists.shape[-1], dtype=torch.float32, device=p.device)
        hue = hues[obj]
        base = torch.stack([hue, 0.5 + 0.5 * torch.cos(6.28 * hue), 1.0 - hue], -1)
        tex = (0.5
               + 0.22 * torch.sin(37.0 * p[..., 0]) * torch.sin(41.0 * p[..., 1])
               + 0.18 * torch.sin(29.0 * p[..., 2] + 3.0 * p[..., 0])
               + 0.1 * torch.sin(113.0 * (p[..., 0] + p[..., 1] + p[..., 2])))
        return torch.clamp(base * tex[..., None] + 0.15, 0.0, 1.0)


def render(scene: Scene, camera: dict, cam_to_world, n_steps: int = 64):
    """Sphere-trace depth [B, H, W] (z in metres, nan where nothing is hit)
    and colour [B, H, W, 3] from poses [B, 4, 4] (camera to world)."""
    dev = scene.sphere_centers.device
    T = torch.as_tensor(np.asarray(cam_to_world), dtype=torch.float32, device=dev)
    H, W = camera["height"], camera["width"]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    dirs_cam = torch.stack([(u - camera["cx"]) / camera["fx"], (v - camera["cy"]) / camera["fy"],
                            torch.ones_like(u)], -1)
    dn = dirs_cam / torch.linalg.norm(dirs_cam, dim=-1, keepdim=True)       # [H, W, 3]
    origin = T[:, None, None, :3, 3]                                         # [B, 1, 1, 3]
    dirs = torch.einsum("hwk,bjk->bhwj", dn, T[:, :3, :3])                  # [B, H, W, 3]
    B = T.shape[0]
    t = torch.full((B, H, W), 0.05, dtype=torch.float32, device=dev)
    done = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        d = scene.sdf(origin + t[..., None] * dirs)
        done = done | (d < 1e-4)
        t = torch.where(done, t, t + torch.clamp(d, min=1e-4))
    hit = done & (t < 12.0)
    p = origin + t[..., None] * dirs
    color = scene.color(p)
    eps = 1e-3
    grad = []
    for axis in range(3):
        e = torch.zeros(3, dtype=torch.float32, device=dev)
        e[axis] = eps
        grad.append(scene.sdf(p + e) - scene.sdf(p - e))
    n = torch.stack(grad, -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    light = torch.tensor([0.3, -0.8, -0.52], dtype=torch.float32, device=dev)
    shade = 0.6 + 0.4 * torch.clamp(torch.sum(n * light, -1), 0, 1)
    color = color * shade[..., None]
    depth = torch.where(hit, t * dn[..., 2], torch.nan)
    color = torch.where(hit[..., None], color, 0.0)
    return depth, color


def look_at(eye: np.ndarray) -> np.ndarray:
    """Rotation (camera to world) of a y-down camera at ``eye`` looking at
    the scene's centre."""
    fwd = TARGET - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd], 1)


def orbit_poses(n: int, phase: float, step: float, radius: float, jitter: np.ndarray):
    """``orbit_trajectory`` continued past a full turn: frame k at angle
    ``phase + k * step``; ``jitter`` [n, 3] moves each camera centre after
    its view direction is set. Returns [n, 4, 4] float32."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k in range(n):
        a = phase + k * step
        eye = np.array([radius * math.sin(a), 0.1 * math.sin(2.5 * a),
                        -0.2 + 0.15 * math.cos(a) - 0.15])
        poses[k, :3, :3] = look_at(eye)
        poses[k, :3, 3] = eye + jitter[k]
    return poses


def multiloop_poses(frames: np.ndarray, n_total: int, n_loops: int, radius: float,
                    jitter: np.ndarray):
    """Frames ``frames`` (indices into a scan of ``n_total``) of
    ``multiloop_trajectory``: ``n_loops`` out-and-back excursions, each
    back at the start pose; ``jitter`` [len(frames), 3] moves each camera
    centre before its view direction is set. Returns [n, 4, 4] float32."""
    per = n_total / float(n_loops)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(frames), 1, 1))
    for k, i in enumerate(frames):
        loop = min(int(i / per), n_loops - 1)
        s = min(max((i - loop * per) / max(per - 1.0, 1.0), 0.0), 1.0)
        a = math.pi / 2.0 * math.sin(math.pi * s) ** 2
        a = (1.0 if loop % 2 == 0 else -1.0) * a
        lift = 0.1 * loop
        eye = np.array([radius * math.sin(a),
                        0.12 * math.sin(4.0 * math.pi * s) + lift * math.sin(math.pi * s) ** 2,
                        -0.35 + 0.2 * (1.0 - math.cos(a))]) + jitter[k]
        poses[k, :3, :3] = look_at(eye)
        poses[k, :3, 3] = eye
    return poses


def scan_poses(traffic: dict, seed: int, n: int) -> np.ndarray:
    """The ground-truth poses [n, 4, 4] (camera to world) of the first
    ``n`` frames that ``traffic`` offers under ``seed``. The scan starts at
    ``scan.start`` (a fraction of a turn, or of the scan); the seed draws the
    per-frame camera jitter."""
    scan = traffic["scan"]
    start = scan["start"]
    jitter = np.random.default_rng(seed).normal(scale=scan["jitter_m"], size=(n, 3))
    if scan["trajectory"] == "orbit":
        return orbit_poses(n, 2.0 * math.pi * start, scan["step_rad"], scan["radius"], jitter)
    if scan["trajectory"] == "multiloop":
        total = scan["frames"]
        frames = (int(start * total) + np.arange(n)) % total
        return multiloop_poses(frames, total, scan["loops"], scan["radius"], jitter)
    raise ValueError(f"unknown trajectory {scan['trajectory']!r}")


def noise_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    return g


def make_scan(traffic: dict, camera: dict, seed: int, n: int, device, batch: int = 8) -> dict:
    """Render the ``n`` frames of ``traffic`` under ``seed`` on ``device``
    in batches of ``batch`` poses. Returns numpy ``depth`` uint16 mm [n, H,
    W], ``color`` uint8 [n, H, W, 3] and ``poses`` [n, 4, 4]; the depth
    carries multiplicative Gaussian noise of ``noise.depth_rel`` drawn from
    the seed on the device."""
    poses = scan_poses(traffic, seed, n)
    scene = Scene(device)
    gen = noise_generator(seed, device)
    sigma = traffic["noise"]["depth_rel"]
    H, W = camera["height"], camera["width"]
    depth = np.zeros((n, H, W), np.uint16)
    color = np.zeros((n, H, W, 3), np.uint8)
    for s0 in range(0, n, batch):
        d, c = render(scene, camera, poses[s0:s0 + batch])
        if sigma > 0:
            d = d + torch.randn(d.shape, generator=gen, device=d.device) * sigma * d
        d = torch.where(torch.isfinite(d), d, 0.0)
        depth[s0:s0 + batch] = torch.clamp(d * 1000.0 + 0.5, 0, 65535).to(torch.int32).cpu().numpy()
        color[s0:s0 + batch] = torch.clamp(c * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()
    return {"depth": depth, "color": color, "poses": poses}
