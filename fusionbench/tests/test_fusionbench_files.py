"""Every cell, configuration, traffic mix, limit and metric loads from its
files, and ``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from fusionbench import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fusionbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    spec = run.cell_spec(cell)
    assert spec["workload"]["chips"] in (1, 4)
    assert spec["traffic"]["loop"] in ("open", "closed")
    # each guarantee has a number compared: tracking and the map at the
    # reported poses one of their two each
    tracking = [k for k in ("pose_err_rms_cm", "pose_ate_cm") if k in spec["limits"]]
    at_pose = [k for k in ("map_sdf_off_pct", "map_sdf_far_pct") if k in spec["limits"]]
    assert len(tracking) == 1 and len(at_pose) == 1
    for k in tracking + at_pose + ["map_weight_gap", "render_depth_p50_mm", "map_samples"]:
        assert spec["limits"][k] > 0
    kinds = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert m["moves"] in kinds, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads(metric):
    assert callable(run.load_reader(metric).read)


def test_names_units_and_entries():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fusionbench/")
        f = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for item in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(item["name"]), item["name"]
        for k in ("why", "layer", "source"):
            if k in item:
                assert 1 <= len(item[k]) <= 200 and "\n" not in item[k] and "\t" not in item[k]
        if "unit" in item:
            assert UNIT.match(item["unit"])
        if "better" in item:
            assert item["better"] in ("lower", "higher")
        for cell in item.get("workloads", []):
            assert cell in CELLS
    names = [x["name"] for x in BENCH["configs"]] + CELLS + METRICS
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_reduced_keys_are_the_changed_ones(name):
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
    import dataclasses

    c = [c for c in BENCH["configs"] if c["name"] == name][0]
    f = json.load(open(os.path.join(run.ROOT, c["file"])))
    changed = set()
    for group, default in (("app", AppConfig()), ("bundling", BundlingConfig())):
        base = dataclasses.asdict(default)
        assert set(f[group]) == set(base)
        changed |= {k for k, v in f[group].items() if base[k] != v}
    assert changed == set(c["reduced"])


def test_roofline_counts_match_the_kernel_table():
    from fusionbench import roofline

    # PERF.md's kernel table: the greedy filter at 10 pairs x 128 raw
    # matches bounds at 0.0000163 ms by its bytes
    ms, by = roofline.kabsch_filter(10, 128, 254, 0)
    assert by == "bytes" and abs(ms - 0.0000163) < 5e-7
    assert roofline.bound_ms(3.35e9, 0)[0] == 1.0
