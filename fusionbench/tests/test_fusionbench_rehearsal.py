"""A small CPU rehearsal of whole runs through the harness (the look for a
card skipped): the result's last line has exactly the contract's keys, and
with the timed path broken underneath, ``correct`` comes out false."""

import json
import time

import numpy as np
import pytest
import torch

from fusionbench import run, system
from fusionbench.tests.small import small

torch.set_num_threads(2)
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(cell, seed=101, seconds=2.0, trace=False, system_cls=None, **traffic):
    return run.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                        overrides=small(cell, **traffic), system_cls=system_cls)


@pytest.fixture(scope="module")
def offline():
    return _run("default.offline")


def test_result_has_the_contract_keys(offline):
    assert set(offline) == RESULT_KEYS
    assert list(offline)[-1] == "checks"
    assert set(offline["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(offline["metrics"]) == {"fps", "setup_s"}
    for m in offline["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.loads(json.dumps(offline, allow_nan=False))


def test_sound_rehearsal_is_correct(offline):
    assert offline["correct"], offline["checks"]
    assert offline["attempted"] > 0


def test_open_loop_rehearsal_offers_every_due_frame():
    # the live cell at the small size's 4 Hz for 2 s
    res = _run("default.live")
    assert res["attempted"] == 8 and res["failed"] == 0
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"frame_ms_p95", "ate_cm", "setup_s"}


def test_traced_live_run_reports_per_layer_metrics():
    res = _run("default.live", trace=True)
    assert set(res["metrics"]) == {"host_frame_ms.live", "boundary_ms.live", "solve_ms.live",
                                   "frame_step_dev_ms.live"}
    assert res["correct"], res["checks"]


def test_traced_offline_run_reports_per_layer_metrics():
    res = _run("default.offline", trace=True)
    assert set(res) == RESULT_KEYS | {"breakdown"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    names = set(res["metrics"])
    # the device's own readings need a card; the rest are read on the CPU too
    assert {"host_frame_ms.offline", "boundary_ms.offline", "solve_ms.offline",
            "frame_step_dev_ms.offline", "fusion_dev_ms.offline"} <= names
    assert res["correct"], res["checks"]


class Unchanged(system.System):
    """A step that returns its state unchanged: no frame reaches the engine."""

    def process(self, handle):
        return system.Done()


class HalfFused(system.System):
    """Half of the frames left out of the fusion: every other frame's TSDF
    dispatch is skipped, the map the mean of the rest."""

    def warmup(self):
        super().warmup()
        dispatch = self.eng._tsdf_dispatch

        def every_other(*a, **kw):
            if self.eng.frame_idx % 2:
                return None
            return dispatch(*a, **kw)

        self.eng._tsdf_dispatch = every_other


class PoseAltered(system.System):
    """An answer altered where it is produced: one frame's optimised pose
    moved by 1 m."""

    def trajectory(self):
        t = super().trajectory().copy()
        t[len(t) // 2, 0, 3] += 1.0
        return t


class SdfAltered(system.System):
    """An answer altered where it is produced: every stored distance of the
    map two voxels off, its weights untouched."""

    def map_sample(self, n, seed, voxel_size):
        m = super().map_sample(n, seed, voxel_size)
        return {**m, "sdf": m["sdf"] + 2.0 * voxel_size}


class RenderAltered(system.System):
    """An answer altered where it is produced: the last render 5 cm deeper."""

    def last_render(self):
        r = super().last_render()
        return None if r is None else r + 0.05


@pytest.mark.parametrize("fault", [Unchanged, HalfFused, PoseAltered, SdfAltered, RenderAltered],
                         ids=lambda c: c.__name__)
def test_a_broken_timed_path_is_not_correct(fault):
    res = _run("default.offline", system_cls=fault)
    assert not res["correct"], res["checks"]


def test_checks_print_each_number_beside_its_limit(offline):
    for k, c in offline["checks"].items():
        assert set(c) == {"value", "limit"}
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"]
