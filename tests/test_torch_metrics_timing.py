"""The port's ``evaluate_ate_rmse`` against the JAX package's on a seeded
trajectory (rtol 1e-5), its ``TimingLog`` (stages, and the span records,
waits and counters it keeps while tracing), and the rule that the engine
never lands on the CPU unasked."""

import time

import numpy as np
import pytest
import torch

from bundlefusion_tpu.utils import metrics as jmetrics
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, orbit_trajectory
from bundlefusion_tpu_torch.pipeline.online import BundleFusion
from bundlefusion_tpu_torch import utils
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
    syncs = []
    log = timing.TimingLog(sync=lambda: syncs.append(1))
    for _ in range(2):
        with log.stage("time_solve"):
            time.sleep(0.002)
    log.trace(True)
    try:
        log.frame = 3
        with timing.stage(log, "time_misc"):
            pass
    finally:
        log.trace(False)
    log.add("time_misc", 0.5)
    assert len(syncs) == 6                       # on entry and on exit of each stage
    assert log.totals()["time_solve"] >= 0.004
    assert log.averages()["time_solve"] == pytest.approx(log.totals()["time_solve"] / 2)
    assert log.medians()["time_misc"] == pytest.approx(0.25, abs=0.01)
    assert "time_solve" in log.print_all_timings()
    # a traced stage is a span too, tagged with the frame; its sample is the
    # span's own duration
    (rec,) = log.spans()
    assert rec["name"] == "time_misc" and rec["frame"] == 3 and rec["parent"] is None
    assert log._samples["time_misc"][0] == pytest.approx(1e-9 * (rec["t1_ns"] - rec["t0_ns"]))
    assert log.spans() == []                     # handed over once
    # no log, or a disabled one: the stage is a no-op
    with timing.stage(None, "x"), timing.stage(timing.TimingLog(enabled=False), "x"):
        pass


def test_spans_nest_with_parents_and_self_time():
    log = timing.TimingLog()
    log.trace(True)
    try:
        log.frame = 5
        with log.stage("time_outer"):
            time.sleep(0.003)
            with log.span("inner_a"):
                time.sleep(0.004)
                with log.span("leaf", frame=6):
                    time.sleep(0.002)
            with log.span("inner_b"):
                pass
    finally:
        log.trace(False)
    recs = {r["name"]: r for r in log.spans()}
    assert list(recs) == ["leaf", "inner_a", "inner_b", "time_outer"]   # order of closing
    outer, a, leaf, b = recs["time_outer"], recs["inner_a"], recs["leaf"], recs["inner_b"]
    assert outer["parent"] is None and a["parent"] == b["parent"] == outer["id"]
    assert leaf["parent"] == a["id"] and len({r["id"] for r in recs.values()}) == 4
    assert (outer["frame"], a["frame"], leaf["frame"]) == (5, 5, 6)
    dur = {k: r["t1_ns"] - r["t0_ns"] for k, r in recs.items()}
    assert outer["t0_ns"] <= a["t0_ns"] <= leaf["t0_ns"] <= leaf["t1_ns"] <= a["t1_ns"] \
        <= b["t0_ns"] <= b["t1_ns"] <= outer["t1_ns"]
    assert a["self_ns"] == dur["inner_a"] - dur["leaf"] >= 4_000_000
    assert outer["self_ns"] == dur["time_outer"] - dur["inner_a"] - dur["inner_b"] >= 3_000_000
    assert leaf["self_ns"] == dur["leaf"]


def test_a_blocking_read_is_charged_to_the_innermost_span():
    """A fake read that blocks 5 ms: its wait and one read go to the span
    that is innermost when it runs, and up the tree as the inclusive wait;
    counters do the same; ``host_reads`` counts only counted reads."""
    def blocking():
        time.sleep(0.005)
        return 42

    log = timing.TimingLog()
    n0 = utils.host_reads["count"]
    log.trace(True)
    try:
        with log.span("outer"):
            timing.count("gn_steps", 2)
            with log.span("inner"):
                assert utils.host_wait(blocking) == 42
                timing.count("gn_steps")
            assert utils.host_wait(blocking, counted=False) == 42
    finally:
        log.trace(False)
    inner, outer = log.spans()
    assert utils.host_reads["count"] == n0 + 1
    assert inner["counters"] == {"reads": 1, "gn_steps": 1}
    assert 5_000_000 <= inner["wait_ns"] == inner["wait_incl_ns"] <= inner["t1_ns"] - inner["t0_ns"]
    assert outer["counters"] == {"reads": 1, "gn_steps": 2}
    assert outer["counters_incl"] == {"reads": 2, "gn_steps": 3}
    assert outer["wait_ns"] >= 5_000_000
    assert outer["wait_incl_ns"] == outer["wait_ns"] + inner["wait_ns"]
    # outside any span, or with no log tracing: nothing is charged
    utils.host_wait(lambda: None, counted=False)
    timing.count("gn_steps")
    assert timing.active() is None and log.spans() == []


def test_tracing_off_keeps_no_record_and_reads_no_extra_clock(monkeypatch):
    """Off, a stage reads the clock twice, as it always did, and a span, a
    counter and a counted read add no clock read and no record."""
    calls = {"perf_counter": 0, "perf_counter_ns": 0}

    class Clock:
        @staticmethod
        def perf_counter():
            calls["perf_counter"] += 1
            return time.perf_counter()

        @staticmethod
        def perf_counter_ns():
            calls["perf_counter_ns"] += 1
            return time.perf_counter_ns()

    monkeypatch.setattr(timing, "time", Clock)
    monkeypatch.setattr(utils, "time", Clock)
    log = timing.TimingLog()
    with log.stage("time_frame_step"):
        with log.span("graph_launch") as sp:
            assert sp is None
            timing.count("gn_steps")
            assert utils.read_host(torch.ones(2)) == [1.0, 1.0]
    assert calls == {"perf_counter": 2, "perf_counter_ns": 0}
    assert log.spans() == [] and len(log._samples["time_frame_step"]) == 1
    # on: the same stage reads the nanosecond clock instead, once per end
    log.trace(True)
    try:
        with log.stage("time_frame_step"):
            pass
    finally:
        log.trace(False)
    assert calls == {"perf_counter": 2, "perf_counter_ns": 2}


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
