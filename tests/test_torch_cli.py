"""The port's command line: ``python -m bundlefusion_tpu_torch`` over the
synthetic sequence at the small configuration on the CPU writes the
trajectory, the mesh and ``processed.txt``; without a card and without
``--device`` it refuses; over the recorded fixture ``tiny.sens`` it runs end
to end, writes the optimized trajectory back into ``<out>/tiny.sens`` and,
with ``--dump-viz``, the render images; ``--max-frames`` caps a ``.sens``
input; a missing input is refused."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["OMP_NUM_THREADS"] = "2"      # it runs beside the other test workers
    return subprocess.run([sys.executable, "-m", "bundlefusion_tpu_torch", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    return _cli("--synthetic", "9", "--small", "--device", "cpu", "--out", str(out)), out


def test_cli_exits_clean_and_reports(cli_run):
    res, _ = cli_run
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ATE RMSE" in res.stdout and "time_submap_step" in res.stdout


def test_cli_writes_trajectory(cli_run):
    _, out = cli_run
    traj = np.loadtxt(out / "trajectory.txt").reshape(-1, 4, 4)
    assert traj.shape == (9, 4, 4) and np.isfinite(traj).all()
    np.testing.assert_allclose(traj[:, 3], np.tile([0, 0, 0, 1.0], (9, 1)), atol=1e-6)


def test_cli_writes_mesh(cli_run):
    _, out = cli_run
    with open(out / "synthetic.ply", "rb") as fh:
        head = fh.read(200).decode("ascii", "replace")
    assert head.startswith("ply") and "element vertex" in head
    n_vertices = int(head.split("element vertex ")[1].split()[0])
    assert n_vertices > 3 * 10_000


def test_cli_writes_verdict(cli_run):
    _, out = cli_run
    verdict = json.loads((out / "processed.txt").read_text())
    assert verdict["valid"] is True
    assert verdict["numTransforms"] == verdict["numValidOptTransforms"] == 9
    assert verdict["ate_rmse_m"] < 0.06 and verdict["fps"] > 0
    assert 0 < verdict["heapFreeCount"] < 8192


def test_cli_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    res = _cli("--synthetic", "2", "--small", "--out", str(tmp_path))
    assert res.returncode != 0 and "CUDA" in res.stderr
    assert not os.listdir(tmp_path)


def test_cli_names_the_roadmap_for_recorded_inputs(tmp_path):
    """Recorded inputs are ported now: a missing one is refused by name
    before any work."""
    res = _cli("--input", "scene.sens", "--device", "cpu", "--out", str(tmp_path / "o"))
    assert res.returncode != 0 and "'scene.sens' does not exist" in res.stderr
    assert not (tmp_path / "o").exists()


FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tiny.sens")


@pytest.fixture(scope="module")
def sens_run(tmp_path_factory):
    """The recorded fixture (12 frames, 160x120, JPEG colour, zlib depth,
    true poses) through the CLI, as ``tests/test_fixture_e2e.py`` runs the
    JAX package's, with ``--dump-viz``."""
    out = tmp_path_factory.mktemp("sens")
    return _cli(FIXTURE, "--small", "--device", "cpu", "--dump-viz", "--out", str(out)), out


def test_cli_end_to_end_on_sens_fixture(sens_run):
    from bundlefusion_tpu_torch.io.sens import load_sens

    res, out = sens_run
    assert res.returncode == 0, res.stderr[-2000:]
    verdict = json.loads((out / "processed.txt").read_text())
    assert verdict["valid"] and verdict["numTransforms"] == 12
    assert verdict["numValidOptTransforms"] >= 10
    assert verdict["ate_rmse_m"] < 0.06
    assert (out / "tiny.ply").exists()
    # the optimized trajectory is written back into <out>/tiny.sens
    reread = load_sens(str(out / "tiny.sens"))
    traj = reread.gt_trajectory()
    assert len(traj) == 12 and np.isfinite(traj).all(axis=(1, 2)).sum() >= 10
    written = np.loadtxt(out / "trajectory.txt").reshape(-1, 4, 4)
    ok = np.isfinite(traj).all(axis=(1, 2))
    np.testing.assert_array_equal(traj[ok], written[ok].astype(np.float32))
    # everything but the poses is the input's
    src = load_sens(FIXTURE)
    assert [f.depth_bytes for f in reread.frames] == [f.depth_bytes for f in src.frames]
    assert [f.color_bytes for f in reread.frames] == [f.color_bytes for f in src.frames]


def test_cli_dump_viz_images(sens_run):
    import cv2

    res, out = sens_run
    assert "viz: render_" in res.stdout
    for name in ("render_depth.png", "render_normals.png", "render_color.png"):
        img = cv2.imread(str(out / name))
        assert img is not None and img.shape == (60, 80, 3), name
        assert img.max() > 0, name


def test_cli_max_frames_caps_a_sens_input(tmp_path):
    res = _cli(FIXTURE, "--small", "--device", "cpu", "--max-frames", "3", "--out",
               str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    verdict = json.loads((tmp_path / "processed.txt").read_text())
    assert verdict["numTransforms"] == 3
    from bundlefusion_tpu_torch.io.sens import load_sens

    assert len(load_sens(str(tmp_path / "tiny.sens")).frames) == 3
