"""The port's command line: ``python -m bundlefusion_tpu_torch`` over the
synthetic sequence at the small configuration on the CPU writes the
trajectory, the mesh and ``processed.txt``; without a card and without
``--device`` it refuses; recorded inputs name the roadmap item."""

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
    res = _cli("--input", "scene.sens", "--device", "cpu", "--out", str(tmp_path))
    assert res.returncode != 0 and "Queue 1 item 3.5" in res.stderr
