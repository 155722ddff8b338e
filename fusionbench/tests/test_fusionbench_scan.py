"""The scan generator: the seed changes the frames, and the same seed gives
the same frames."""

import numpy as np
import pytest
import torch

from fusionbench import run, scan

CAM = {"width": 64, "height": 48, "fx": 57.0, "fy": 57.0, "cx": 31.5, "cy": 23.5}


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
