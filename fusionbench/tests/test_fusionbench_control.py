"""The controls at a size a test run holds (160x120 on the CPU, 40 frames of
the orbit, whose camera moves from the first frame on, or of the short walk
through four small rooms):
the reference in the program's place with one stated guarantee broken comes
out not correct, each on the number that guards that guarantee."""

import pytest
import torch

from fusionbench import control
from fusionbench.tests.small import small

GUARDS = {"tracking": "pose_err_rms_cm", "fusion": "map_weight_gap", "pose": "map_sdf_off_pct",
          "render": "render_depth_p50_mm"}


@pytest.mark.parametrize("cell", ["default.offline", "default.long"])
@pytest.mark.parametrize("breaks", control.BREAKS)
def test_a_broken_guarantee_is_not_correct(breaks, cell):
    torch.set_num_threads(2)
    out, = control.control_runs(cell, 27182818284, 40, torch.device("cpu"),
                                (breaks,), overrides=small(cell))
    assert not out["correct"], out["numbers"]
    guard = GUARDS[breaks]
    if guard not in out["limits"]:   # the walk holds tracking and the map to other numbers
        guard = {"pose_err_rms_cm": "pose_ate_cm", "map_sdf_off_pct": "map_sdf_far_pct"}[guard]
    assert out["fails"] == [guard], out["numbers"]


def test_the_reference_in_place_of_the_program_is_correct():
    out, = control.control_runs("default.offline", 27182818284, 40, torch.device("cpu"),
                                ("tracking",), lag=0, overrides=small("default.offline"))
    assert out["correct"], out["numbers"]
    assert out["numbers"]["pose_err_rms_cm"] == 0.0
    assert out["numbers"]["map_weight_gap"] == 0.0
    assert out["numbers"]["map_sdf_off_pct"] == 0.0
