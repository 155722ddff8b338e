"""The benchmark's scan generator: seeded RGB-D frames of a synthetic room.

A frozen copy of the port's synthetic renderer (``io/synthetic.py``:
``default_scene``, the scene's signed distance and colour, the sphere
tracer, ``_look_at``, ``orbit_trajectory`` and ``multiloop_trajectory``),
so that a later change to the program cannot move the yardstick. The
tracer here renders a batch of poses in one pass (the same arithmetic per
pixel), on the device it is given.

A traffic file (``traffic/<name>.json``) names the scan, its start and its
noise; the seed draws the camera jitter and the depth noise. Without a
``scan.scene`` key the scene is that one room (``Scene``); a ``rooms``
scene (``Rooms``) is a row of rooms, every number of it in the traffic
file, and its scan is a ``walk`` through them and back. Frames are
made in the sensor's wire format: uint16 millimetre depth (0 where nothing
is hit) and uint8 colour, the format ``.sens`` files hold.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TARGET = np.array([0.0, 0.0, 2.0])
GOLDEN = 0.618034   # hue step between a rooms scene's objects
TRACE_STEPS = 64    # sphere-tracing steps per ray
DROP_EVERY = 4      # steps between drops of the rays that are done


def paint(hue, p):
    """Colour [..., 3] of a surface of hue ``hue`` [...] at world points
    ``p`` [..., 3]: the hue times a high-frequency texture of position."""
    base = torch.stack([hue, 0.5 + 0.5 * torch.cos(6.28 * hue), 1.0 - hue], -1)
    tex = (0.5
           + 0.22 * torch.sin(37.0 * p[..., 0]) * torch.sin(41.0 * p[..., 1])
           + 0.18 * torch.sin(29.0 * p[..., 2] + 3.0 * p[..., 0])
           + 0.1 * torch.sin(113.0 * (p[..., 0] + p[..., 1] + p[..., 2])))
    return torch.clamp(base * tex[..., None] + 0.15, 0.0, 1.0)


def box_sdf(p, centers, halfsizes):
    """Signed distances [..., K] of points [..., 3] to K boxes (centres and
    half sizes broadcast against [..., K, 3])."""
    q = torch.abs(p[..., None, :] - centers) - halfsizes
    return torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
        torch.amax(q, dim=-1), max=0.0)


class Scene:
    """Floor, three boxes and three spheres in front of the origin (+y is
    down), as ``io/synthetic.py`` ``default_scene``."""

    def __init__(self, device):
        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        self.device = device
        self.sphere_centers = f32([[0.35, 0.0, 1.9], [-0.5, 0.25, 2.3], [0.1, -0.35, 1.5]])
        self.sphere_radii = f32([0.3, 0.22, 0.15])
        self.box_centers = f32([[-0.45, -0.3, 1.8], [0.7, 0.35, 2.6], [0.0, 0.65, 2.2]])
        self.box_halfsizes = f32([[0.25, 0.25, 0.25], [0.3, 0.2, 0.3], [0.9, 0.05, 0.8]])
        self.floor_y = 0.85

    def distances(self, p):
        """Per-object signed distances [..., 7] at world points [..., 3]."""
        d_sph = torch.linalg.norm(p[..., None, :] - self.sphere_centers, dim=-1) - self.sphere_radii
        d_box = box_sdf(p, self.box_centers, self.box_halfsizes)
        d_floor = (self.floor_y - p[..., 1])[..., None]
        return torch.cat([d_sph, d_box, d_floor], -1)

    def sdf(self, p):
        return torch.amin(self.distances(p), dim=-1)

    def color(self, p):
        """Per-object hue times a high-frequency texture."""
        dists = self.distances(p)
        obj = torch.argmin(dists, dim=-1)
        hues = torch.linspace(0.05, 0.95, dists.shape[-1], dtype=torch.float32, device=p.device)
        return paint(hues[obj], p)


class Rooms:
    """``rooms`` rooms in a row along +z (+y is down), each ``size_m`` =
    (width, length, height), from z = 0; floor at ``floor_y``; each shared
    wall ``wall_m`` thick with a doorway ``door_m`` = (width, height) at x =
    0 on the floor. Each room's entry of ``room`` lists its boxes ``[x, y,
    z, hx, hy, hz]`` and spheres ``[x, y, z, r]`` (z from the room's start)
    and the panels of its side walls: ``panels_z`` (cuts along z, from the
    room's start) and ``panel_y`` (one cut in height). Every object, panel,
    floor and ceiling has a hue of its own, so that no stretch of wall looks
    like another.

    A point is held against its own room's objects only. That is exact
    while each object keeps at least half the doorway's width from the
    shared walls (checked here): a nearer object of another room lies
    behind a wall, or through the doorway, beyond a jamb that is nearer."""

    def __init__(self, spec: dict, device):
        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        self.device = device
        n = self.n = spec["rooms"]
        W, L, H = spec["size_m"]
        door_w, door_h = spec["door_m"]
        t = 0.5 * spec["wall_m"]
        rooms = spec["room"]
        if n < 2 or len(rooms) != n:
            raise ValueError(f"a rooms scene needs 2 or more rooms, each listed: {n}, {len(rooms)}")
        self.W, self.L = W, L
        self.floor_y, self.ceil_y = spec["floor_y"], spec["floor_y"] - H
        for r, room in enumerate(rooms):
            for z, hz in [(b[2], b[5]) for b in room["boxes"]] + [(s_[2], s_[3])
                                                                for s_ in room["spheres"]]:
                if z - hz < 0.5 * door_w or z + hz > L - 0.5 * door_w:
                    raise ValueError(f"room {r}: an object within {0.5 * door_w} m of a wall")
        # the shared wall's three pieces, beside and above the doorway, in
        # the wall's own z (0 at its plane)
        mid_y = 0.5 * (self.floor_y + self.ceil_y)
        top = self.floor_y - door_h
        side = 0.5 * (0.5 * W - 0.5 * door_w)
        self.piece_c = f32([[-0.5 * W + side, mid_y, 0.0], [0.5 * W - side, mid_y, 0.0],
                            [0.0, 0.5 * (self.ceil_y + top), 0.0]])
        self.piece_h = f32([[side, 0.5 * H, t], [side, 0.5 * H, t],
                            [0.5 * door_w, 0.5 * (top - self.ceil_y), t]])

        def world(xyz, r):
            return [xyz[0], xyz[1], xyz[2] + r * L]

        self.box_c = f32([[world(b[:3], r) for b in room["boxes"]] for r, room in enumerate(rooms)])
        self.box_h = f32([[b[3:] for b in room["boxes"]] for room in rooms])
        self.sph_c = f32([[world(s_[:3], r) for s_ in room["spheres"]]
                          for r, room in enumerate(rooms)])
        self.sph_r = f32([[s_[3] for s_ in room["spheres"]] for room in rooms])
        self.panel_z = f32(sorted(r * L + z for r, room in enumerate(rooms)
                                  for z in room["panels_z"]))
        self.panel_y = f32([room["panel_y"] for room in rooms])
        n_obj = self.box_c.shape[1] + self.sph_c.shape[1]
        panels = self.panel_z.numel() + 1
        # object ids: floor, ceiling (per room), the side walls' panels (two
        # heights), the two end walls, the shared walls, the rooms' objects
        self._ids = {"floor": 0, "ceil": n, "left": 2 * n, "right": 2 * n + 2 * panels,
                     "ends": 2 * n + 4 * panels, "shared": 2 * n + 4 * panels + 2}
        self._ids["objects"] = self._ids["shared"] + (n - 1)
        self.n_ids = self._ids["objects"] + n * n_obj

    def _room(self, z):
        return torch.clamp(torch.floor(z / self.L), 0, self.n - 1).to(torch.int64)

    def _wall(self, z):
        return torch.clamp(torch.round(z / self.L), 1, self.n - 1)

    def distances(self, p):
        """Signed distances [..., 15] at world points [..., 3]: floor,
        ceiling, the side and end walls, the nearest shared wall's three
        pieces, the point's room's spheres and boxes."""
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        planes = torch.stack([self.floor_y - y, y - self.ceil_y, x + 0.5 * self.W,
                              0.5 * self.W - x, z, self.n * self.L - z], -1)
        zw = z - self._wall(z) * self.L
        d_wall = box_sdf(torch.stack([x, y, zw], -1), self.piece_c, self.piece_h)
        r = self._room(z)
        d_sph = torch.linalg.norm(p[..., None, :] - self.sph_c[r], dim=-1) - self.sph_r[r]
        d_box = box_sdf(p, self.box_c[r], self.box_h[r])
        return torch.cat([planes, d_wall, d_sph, d_box], -1)

    def sdf(self, p):
        return torch.amin(self.distances(p), dim=-1)

    def color(self, p):
        """Each object's hue (a golden-ratio step per object id) times the
        texture of position."""
        d = self.distances(p)
        k = torch.argmin(d, dim=-1)
        z, y = p[..., 2], p[..., 1]
        r = self._room(z)
        panel = 2 * torch.bucketize(z.contiguous(), self.panel_z) + (y > self.panel_y[r]).to(torch.int64)
        ids = self._ids
        per_col = [ids["floor"] + r, ids["ceil"] + r, ids["left"] + panel, ids["right"] + panel,
                   torch.full_like(r, ids["ends"]), torch.full_like(r, ids["ends"] + 1)]
        wall = ids["shared"] + self._wall(z).to(torch.int64) - 1
        per_col += [wall] * 3
        n_obj = d.shape[-1] - len(per_col)
        obj = ids["objects"] + r[..., None] * n_obj + torch.arange(n_obj, device=p.device)
        table = torch.cat([torch.stack(per_col, -1), obj], -1)
        oid = torch.gather(table, -1, k[..., None])[..., 0]
        hue = torch.frac(0.1 + GOLDEN * oid.to(torch.float32))
        return paint(hue, p)


def make_scene(spec, device):
    """The scene a traffic's ``scan.scene`` names: ``Scene`` without one."""
    if spec is None:
        return Scene(device)
    if spec["kind"] == "rooms":
        return Rooms(spec, device)
    raise ValueError(f"unknown scene kind {spec['kind']!r}")


def trace_live(scene, origin, dirs, t, done) -> None:
    """The sphere tracer's ``TRACE_STEPS`` steps on rays [N] (origins and
    directions [N, 3]; ``t`` and ``done`` updated in place): a ray steps by
    its distance to the scene until that is under 0.1 mm. Every
    ``DROP_EVERY`` steps the rays that are done are dropped from the set
    that is stepped, so a step costs what the rays still open cost; a done
    ray keeps its ``t``, so each ray's arithmetic is that of stepping every
    ray every time (the one room's frames hash as they did under that
    loop)."""
    live = torch.arange(t.shape[0], device=t.device)
    for step in range(TRACE_STEPS):
        if step and step % DROP_EVERY == 0:
            live = live[~done[live]]
            if live.numel() == 0:
                return
        tl = t[live]
        d = scene.sdf(origin[live] + tl[:, None] * dirs[live])
        dl = done[live] | (d < 1e-4)
        done[live] = dl
        t[live] = torch.where(dl, tl, tl + torch.clamp(d, min=1e-4))


def render(scene, camera: dict, cam_to_world):
    """Sphere-trace depth [B, H, W] (z in metres, nan where nothing is hit)
    and colour [B, H, W, 3] from poses [B, 4, 4] (camera to world)."""
    dev = scene.device
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
    trace_live(scene, origin.expand(B, H, W, 3).reshape(-1, 3), dirs.reshape(-1, 3),
               t.view(-1), done.view(-1))
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
    return facing(TARGET - eye)


def facing(fwd: np.ndarray) -> np.ndarray:
    """Rotation (camera to world) of a y-down camera looking along ``fwd``."""
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


def walk_poses(frames: np.ndarray, n_total: int, scan: dict, jitter: np.ndarray):
    """Frames ``frames`` (indices into a scan of ``n_total``) of ``walk``:
    out along +z from ``z_m[0]`` to ``z_m[1]`` over the first half of the
    scan and back over the second, starting and stopping smoothly, at x =
    ``path_x`` and y = ``eye_y``; on the way back the camera is moved by up
    to ``return_offset_m`` (x, y), which vanishes at both ends. Its heading
    sweeps ``sweep_deg`` either side of ``yaw_deg`` (degrees from +z
    towards +x: -90 faces the -x wall), and its pitch ``pitch_sweep_deg``
    either side of ``pitch_deg`` (down), both with period ``period``
    frames, which divides ``n_total``: the scan ends on its start pose, and
    the way back passes each place near the way out's pose there.
    ``jitter`` [len(frames), 3] moves each camera centre. Returns [n, 4, 4]
    float32."""
    half = n_total / 2.0
    period = scan["period"]
    if n_total % period or n_total % 2:
        raise ValueError(f"a walk of {n_total} frames needs an even count and period {period}")
    z0, z1 = scan["z_m"]
    dx, dy = scan["return_offset_m"]
    poses = np.tile(np.eye(4, dtype=np.float32), (len(frames), 1, 1))
    for k, i in enumerate(frames):
        back = i > half
        s = (n_total - i if back else i) / half
        off = math.sin(math.pi * (i - half) / half) if back else 0.0
        phase = 2.0 * math.pi * i / period
        yaw = math.radians(scan["yaw_deg"] + scan["sweep_deg"] * math.cos(phase))
        pitch = math.radians(scan["pitch_deg"] + scan["pitch_sweep_deg"] * math.sin(phase))
        fwd = np.array([math.cos(pitch) * math.sin(yaw), math.sin(pitch),
                        math.cos(pitch) * math.cos(yaw)])
        poses[k, :3, :3] = facing(fwd)
        poses[k, :3, 3] = np.array([scan["path_x"] + dx * off, scan["eye_y"] + dy * off,
                                    z0 + (z1 - z0) * 0.5 * (1.0 - math.cos(math.pi * s))])
        poses[k, :3, 3] += jitter[k]
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
    total = scan["frames"]
    frames = (int(start * total) + np.arange(n)) % total
    if scan["trajectory"] == "multiloop":
        return multiloop_poses(frames, total, scan["loops"], scan["radius"], jitter)
    if scan["trajectory"] == "walk":
        return walk_poses(frames, total, scan, jitter)
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
    scene = make_scene(traffic["scan"].get("scene"), device)
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
