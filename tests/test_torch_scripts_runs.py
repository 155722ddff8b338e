"""The long-run scripts of the port at small CPU sizes (``scale_run``,
``scaling_harness``, ``drift_capacity``): each runs to its end, passes its
own checks and writes its JSON under ``--out`` and nowhere else in the
checkout (``ablate``: ``tests/test_torch_scripts_ablate.py``)."""

import json
import os

from bundlefusion_tpu_torch.scripts import drift_capacity, scale_run, scaling_harness
from tests.torch_scripts_util import outside_writes, snapshot


def _run(mod, args, out_dir):
    before = snapshot()
    out = mod.main(args + ["--device", "cpu", "--out", str(out_dir)])
    assert outside_writes(before) == []
    return out


def test_scale_run_writes_only_under_out(tmp_path):
    out = _run(scale_run, ["13", "--cache", str(tmp_path / "cache")], tmp_path / "out")
    assert os.listdir(tmp_path / "out") == ["scale_run.json"]
    assert len(os.listdir(tmp_path / "cache")) == 1
    assert out["frames"] == 13 and out["keyframes"] == 3 and out["pairs_dropped"] == 0
    assert not any(out["invariants"].values()) and out["alloc_failures"] == 0
    assert out["platform"] == "cpu" and out["peak_mem_gb"] is None


def test_scaling_harness_writes_only_under_out(tmp_path):
    out = _run(scaling_harness, ["--ranks", "1"], tmp_path)
    assert os.listdir(tmp_path) == ["scaling_harness.json"]
    r = out["results"]["1"]
    assert r["frames"] == scaling_harness.n_frames_for(1) == 19 and r["valid"] == 19
    assert out["weak_scaling_efficiency"] == {"1": 1.0} and out["one_card"] is False


def test_drift_capacity_writes_only_under_out(tmp_path):
    ret = _run(drift_capacity, ["12", "--cache", str(tmp_path / "cache")], tmp_path / "out")
    assert sorted(os.listdir(tmp_path / "out")) == ["drift_capacity.json",
                                                   "drift_capacity.progress.json"]
    with open(tmp_path / "out" / "drift_capacity.json") as fh:
        out = json.load(fh)
    assert out == json.loads(json.dumps(ret))
    assert out["frames"] == 12 and out["keyframe_capacity"] == 3
    assert out["blackouts"] == [[6, 10], [10, 14]]
    assert not any(out["invariants"].values())
    assert len(out["boundaries"]["boundary_ms"]) == len(out["boundaries"]["host_reads_by_g"])
