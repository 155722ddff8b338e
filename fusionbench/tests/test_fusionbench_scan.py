"""The scan generator: the seed changes the frames, and the same seed gives
the same frames; the one-room traffic renders what it rendered before the
rooms scene came; the walk through the rooms keeps to its stated
conditions."""

import copy
import hashlib
import math

import numpy as np
import pytest
import torch

from fusionbench import check, reference, run, scan

CAM = {"width": 64, "height": 48, "fx": 57.0, "fy": 57.0, "cx": 31.5, "cy": 23.5}
WALK = run.load_json(run.os.path.join(run.HERE, "traffic", "walk_long.json"))

# sha256 (first 16 hex digits) of the first three frames of the one-room
# traffic at CAM under seed 3_000_000_001 (depth, colour, true poses) and of
# the reference's render of the scene from their poses at half CAM's size,
# as the harness made them before the rooms scene was added
OLD_HASHES = {"depth": "07b15e2c91a8e1ee", "color": "6d412224137b8c1f",
              "poses": "7128bcbc3281f612", "truth": "41a0c5881c8c4256"}


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _steps(poses):
    """Largest step per frame: (metres, degrees)."""
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    R = poses[:, :3, :3].astype(np.float64)
    rel = np.einsum("nji,njk->nik", R[:-1], R[1:])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return float(d.max()), float(np.degrees(np.arccos(cos)).max())


@pytest.mark.parametrize("cell", ["default.offline", "default.live"])
def test_one_room_traffic_renders_as_before(cell):
    torch.set_num_threads(2)
    t = run.cell_spec(cell)["traffic"]
    assert "scene" not in t["scan"]
    f = scan.make_scan(t, CAM, 3_000_000_001, 3, torch.device("cpu"))
    cam_int = reference.integration_camera(CAM, 32, 24)
    truth = np.stack([reference.render_depth(cam_int, p, torch.device("cpu")) for p in f["poses"]])
    got = {k: _sha(f[k]) for k in ("depth", "color", "poses")}
    got["truth"] = _sha(truth)
    assert got == OLD_HASHES


@pytest.mark.parametrize("trajectory", ["multiloop", "orbit"])
def test_seed_changes_the_frames(trajectory):
    t = run.merge(run.cell_spec("default.offline")["traffic"],
                  {"scan": {"frames": 30, "trajectory": trajectory, "step_rad": 0.0145}})
    a = scan.make_scan(t, CAM, 3_000_000_001, 4, torch.device("cpu"))
    b = scan.make_scan(t, CAM, 3_000_000_001, 4, torch.device("cpu"))
    c = scan.make_scan(t, CAM, 3_000_000_002, 4, torch.device("cpu"))
    for k in ("depth", "color", "poses"):
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["poses"], c["poses"])
    assert not np.array_equal(a["depth"], c["depth"])
    assert a["depth"].dtype == np.uint16 and a["color"].dtype == np.uint8
    assert (a["depth"] > 0).mean() > 0.3   # the scene fills much of the view


def test_scans_move_at_the_bench_orbits_step():
    # the three-loop scan's fastest step is about the bench orbit's
    t = run.cell_spec("default.offline")["traffic"]
    p = scan.scan_poses(t, 5, 1020)
    step = np.linalg.norm(np.diff(p[:, :3, 3], axis=0), axis=1).max()
    orbit = {"scan": {"trajectory": "orbit", "radius": 0.4, "step_rad": 2 * np.pi * 0.25 / 108,
                      "jitter_m": 0.0, "start": 0.0}}
    o = scan.scan_poses(orbit, 5, 108)
    o_step = np.linalg.norm(np.diff(o[:, :3, 3], axis=0), axis=1).max()
    assert 0.5 * o_step < step < 2.0 * o_step


def test_large_seeds_are_taken():
    t = run.cell_spec("default.offline")["traffic"]
    assert scan.scan_poses(t, 2 ** 31 + 12345, 2).shape == (2, 4, 4)
    assert scan.noise_generator(2 ** 40 + 7, "cpu").initial_seed() > 0


def test_walk_steps_no_larger_than_the_three_loop_scans():
    loops = run.cell_spec("default.offline")["traffic"]
    for seed in (5, 2 ** 31 + 77):
        walk = _steps(scan.scan_poses(WALK, seed, WALK["scan"]["frames"] + 1))
        three = _steps(scan.scan_poses(loops, seed, loops["scan"]["frames"] + 1))
        assert walk[0] <= three[0] and walk[1] <= three[1], (walk, three)


def test_walk_ends_on_its_start_and_passes_each_place_twice():
    still = run.merge(WALK, {"scan": {"jitter_m": 0.0}})
    n = still["scan"]["frames"]
    p = scan.scan_poses(still, 1, n + 1)
    assert np.abs(p[n] - p[0]).max() < 1e-6
    # the way back at frame n - i is near the way out at frame i
    back = p[n - np.arange(1, n // 2)]
    out = p[np.arange(1, n // 2)]
    assert np.linalg.norm(back[:, :3, 3] - out[:, :3, 3], axis=1).max() < 0.15
    cos = np.einsum("ni,ni->n", back[:, :3, 2], out[:, :3, 2])
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))).max() < 10.0
    # out to the last room and back: the z range spans rooms 1 to 4
    L = still["scan"]["scene"]["size_m"][1]
    assert p[:, 2, 3].min() < L and p[:, 2, 3].max() > 3 * L


def test_walk_seed_draws_only_the_jitter():
    still = run.merge(WALK, {"scan": {"jitter_m": 0.0}})
    assert np.array_equal(scan.scan_poses(still, 3, 50), scan.scan_poses(still, 4, 50))
    a, b = scan.scan_poses(WALK, 3, 50), scan.scan_poses(WALK, 4, 50)
    assert np.array_equal(a[:, :3, :3], b[:, :3, :3])
    assert 0 < np.abs(a[:, :3, 3] - b[:, :3, 3]).max() < 12 * WALK["scan"]["jitter_m"]


def test_every_walk_frame_sees_depth_on_half_its_pixels():
    # every 40th frame of the walk at a 1/16 size of the cell's camera
    torch.set_num_threads(2)
    cam = {"width": 40, "height": 30, "fx": 35.6, "fy": 35.6, "cx": 19.5, "cy": 14.5}
    p = scan.scan_poses(WALK, 7, WALK["scan"]["frames"])[::40]
    d, _ = scan.render(scan.make_scene(WALK["scan"]["scene"], "cpu"), cam, p)
    d = d.numpy()
    share = (np.isfinite(d) & (d >= 0.1) & (d <= 3.0)).reshape(len(p), -1).mean(1)
    assert share.min() >= 0.5, share.min()


def test_rooms_distance_is_the_distance_to_every_room():
    # the room-local evaluation equals the distance to all rooms' objects
    rooms = scan.make_scene(WALK["scan"]["scene"], "cpu")
    g = torch.Generator().manual_seed(0)
    lo = torch.tensor([-1.5, rooms.ceil_y, 0.0])
    hi = torch.tensor([1.5, rooms.floor_y, rooms.n * rooms.L])
    p = lo + (hi - lo) * torch.rand((20000, 3), generator=g)
    local = rooms.sdf(p)
    d = rooms.distances(p)[..., :9]
    d_sph = (torch.linalg.norm(p[:, None, :] - rooms.sph_c.reshape(-1, 3), dim=-1)
             - rooms.sph_r.reshape(-1))
    d_box = scan.box_sdf(p, rooms.box_c.reshape(-1, 3), rooms.box_h.reshape(-1, 3))
    every = torch.amin(torch.cat([d, d_sph, d_box], -1), -1)
    assert torch.allclose(local, every, atol=1e-6)


def test_an_object_near_a_shared_wall_is_refused():
    spec = copy.deepcopy(WALK["scan"]["scene"])
    spec["room"][1]["spheres"][0][2] = spec["size_m"][1] - 0.3
    with pytest.raises(ValueError):
        scan.make_scene(spec, "cpu")


def test_rooms_look_different():
    # two places one room apart give different colour where both see a wall
    torch.set_num_threads(2)
    still = run.merge(WALK, {"scan": {"jitter_m": 0.0}})
    p = scan.scan_poses(still, 1, 1800)
    L = still["scan"]["scene"]["size_m"][1]
    i = int(np.argmin(np.abs(p[:900, 2, 3] - 1.5)))
    j = i + int(np.argmin(np.abs(p[i:, 2, 3] - (1.5 + L))))
    q = p[[i, i]].copy()
    q[1, 2, 3] += L
    _, c = scan.render(scan.make_scene(still["scan"]["scene"], "cpu"), CAM, q)
    assert j > i and float(torch.abs(c[0] - c[1]).mean()) > 0.1
    assert math.isfinite(float(c.sum()))


def test_leg_gap_reads_a_turn_both_legs_share_as_nought():
    # a walk of 40 frames out and back whose estimate turns about the first
    # frame by 1 degree: both legs share the turn and pass the same places,
    # so the gap is nought;
    # a way back 2 cm off its way out reads 2 cm
    still = run.merge(WALK, {"scan": {"jitter_m": 0.0, "frames": 40, "period": 40,
                                      "return_offset_m": [0.0, 0.0]}})
    truth = reference.relative_poses(scan.scan_poses(still, 1, 40).astype(np.float64))
    a = math.radians(1.0)
    turn = np.eye(4)
    turn[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]]
    turned = turn @ truth
    idx = np.arange(40)
    assert check.pose_errors_cm(turned, truth)[1] > 0.5
    assert check.leg_gap_cm(turned, truth, idx, 40) < 1e-9
    off = turned.copy()
    off[21:, 0, 3] += 0.02
    assert abs(check.leg_gap_cm(off, truth, idx, 40) - 2.0) < 1e-9
    assert math.isnan(check.leg_gap_cm(truth[:20], truth[:20], idx[:20], 40))
