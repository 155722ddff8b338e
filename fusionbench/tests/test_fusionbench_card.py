"""On the card: one short run of each cell through the command, and the
control at the cell's size. Run there with
``python -m pytest -m card fusionbench/tests -q``."""

import json
import os
import subprocess
import sys

import pytest

from fusionbench import run

CELLS = [w["name"] for w in run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "fusionbench", "--workload", cell, "--seed",
                          "2718281828", "--seconds", "4", "--trace", "0"], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    from fusionbench import control

    # an open loop feeds a fixed count; a closed loop its untimed frames and
    # about what 30 s take
    traffic = run.cell_spec(cell)["traffic"]
    frames = max(1100, traffic["warm_frames"] + 700) if traffic["loop"] == "closed" else None
    for out in control.control_runs(cell, 31415926535, frames, card, control.BREAKS):
        assert not out["correct"], (out["breaks"], out["numbers"])
