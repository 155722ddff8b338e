"""The port's ``evaluate_ate_rmse`` against the JAX package's on a seeded
trajectory (rtol 1e-5), its ``TimingLog``, and the rule that the engine
never lands on the CPU unasked."""

import time

import numpy as np
import pytest
import torch

from bundlefusion_tpu.utils import metrics as jmetrics
from bundlefusion_tpu.utils import timing as jtiming
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, orbit_trajectory
from bundlefusion_tpu_torch.pipeline.online import BundleFusion
from bundlefusion_tpu_torch.utils import metrics, timing


def test_ate_rmse_matches():
    rng = np.random.default_rng(0)
    gt = orbit_trajectory(30)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.02, size=(30, 3)).astype(np.float32)
    # a rigid offset is aligned away; lost frames are skipped
    est[:, :3, 3] = est[:, :3, 3] @ np.float32([[0, -1, 0], [1, 0, 0], [0, 0, 1]]) + 0.3
    est[7] = np.nan
    got, n = metrics.evaluate_ate_rmse(est, gt)
    want, jn = jmetrics.evaluate_ate_rmse(est, gt)
    assert n == jn == 29
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 0.01 < got < 0.06
    assert metrics.evaluate_ate_rmse(est[:2], gt[:2]) == (float("inf"), 2)
    with pytest.raises(ValueError):
        metrics.evaluate_ate_rmse(est[:3], gt[:4])


def test_timing_log_stages_accumulate():
    assert list(timing.FrameTiming.__dataclass_fields__) == \
        list(jtiming.FrameTiming.__dataclass_fields__)
    syncs = []
    log = timing.TimingLog(sync=lambda: syncs.append(1))
    ft = log.new_frame(3)
    for _ in range(2):
        with log.stage("time_solve", ft):
            time.sleep(0.002)
    with timing.stage(log, "time_misc"):
        pass
    log.add("time_misc", 0.5)
    assert len(syncs) == 6                       # on entry and on exit of each stage
    assert ft.frame == 3 and ft.time_solve >= 0.004 and ft.time_misc == 0.0
    assert log.totals()["time_solve"] == pytest.approx(ft.time_solve)
    assert log.averages()["time_solve"] == pytest.approx(ft.time_solve / 2)
    assert log.medians()["time_misc"] == pytest.approx(0.25, abs=0.01)
    assert "time_solve" in log.print_all_timings()
    assert log.local_frames == [ft] and log.global_frames == []
    # no log, or a disabled one: the stage is a no-op
    with timing.stage(None, "x"), timing.stage(timing.TimingLog(enabled=False), "x"):
        pass


def test_engine_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intr = default_intrinsics(160, 120)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        BundleFusion(intr)
    small = port.AppConfig(hash_num_sdf_blocks=256, hash_key_capacity=512, max_frames=4)
    eng = BundleFusion(intr, small, port.BundlingConfig(max_num_images=2), device="cpu")
    assert eng.device == torch.device("cpu") and eng.table.sdf.device.type == "cpu"
    assert eng.local.keys.pos.device.type == "cpu"
