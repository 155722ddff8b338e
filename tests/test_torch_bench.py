"""``bundlefusion_tpu_torch.bench`` at its CPU size against ``bench.py``.

(a) ``bench.py`` runs unchanged in a child process on the CPU, and the
port's ``bench.run`` takes the same frames: the JAX renderer's 17-frame
orbit at 160x120 (``bench.py``'s own CPU call), at the same small
configuration. Required: the port's line has every key of the JAX line;
valid and total frames, dropped pairs, the re-integration counters and the
replay's stage names are equal; the ATE is within ``ATE_TOL_CM``.

The JAX engine retires a boundary's pack at the first frame that finds its
copy to the host done (``is_ready``); the port reads it back at the end of
the boundary's own frame. Under JAX's default asynchronous CPU dispatch the
host runs frames ahead of the work and the packs land 9-11 frames late, so
re-integration starts later and the counters follow the host's speed
(ROADMAP Queue 3). The child process that the port is held against
therefore turns asynchronous dispatch off before it runs ``bench.py``: each
pack is ready when the next frame starts, as in the port. A second child
runs ``bench.py`` as its users do, asynchronous: there the JAX counters are
no higher than the port's (a pack that lands later re-integrates later)
and the rest of the comparison holds as it is.

(b) ``main(["--device", "cpu"])`` prints one JSON line, last. (c) Without
a card and without ``--device cpu`` it raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu_torch import bench
from bundlefusion_tpu_torch.pipeline.online import BundleFusion
from tests.torch_scripts_util import ROOT

N_FRAMES = 17       # bench.py's CPU windows: 13 + 0 + 4
# bench.py prints the ATE rounded to 0.001 cm; the two sides read 1.420 and
# 1.41995 cm. 0.01 cm (0.1 mm) fails a fault that moves the ATE by more than
# a tenth of a millimetre.
ATE_TOL_CM = 0.01
EXACT = ("valid_frames", "total_frames", "pairs_dropped")
REINT = ("reint_frames", "reint_ops", "reint_frames_timed", "reint_ops_timed")
COUNTERS = EXACT + REINT

_RUN_JAX_BENCH = """
import runpy
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_enable_async_dispatch", sys.argv[1] == "async")
sys.argv = ["bench.py"]
runpy.run_path("bench.py", run_name="__main__")
"""


@pytest.fixture(scope="module")
def jax_lines():
    """``bench.py``'s line by dispatch mode, ``sync`` and ``async``: the two
    children run side by side."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = {mode: subprocess.Popen([sys.executable, "-c", _RUN_JAX_BENCH, mode], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for mode in ("sync", "async")}
    lines = {}
    try:
        for mode, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, (mode, err[-4000:])
            lines[mode] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return lines


@pytest.fixture(scope="module")
def jax_line(jax_lines):
    return jax_lines["sync"]


@pytest.fixture(scope="module")
def port_run():
    """The port's bench on the JAX renderer's frames: (line, engine)."""
    seq = make_sequence(N_FRAMES, intr=default_intrinsics(160, 120))
    seq = {k: np.asarray(seq[k]) for k in ("depth", "color", "poses")}
    dev = torch.device("cpu")
    intr, app, bundling, sift_cfg, max_keyframes, windows = bench.configure(dev)
    assert windows.total == N_FRAMES
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=max_keyframes,
                       device=dev)
    return bench.run(eng, seq, windows, dev), eng


def test_keys_include_the_jax_lines(jax_line, port_run):
    line, _ = port_run
    assert set(jax_line) <= set(line), sorted(set(jax_line) - set(line))
    assert json.loads(json.dumps(line)) == line
    assert line["platform"] == jax_line["platform"] == "cpu"


def test_counters_equal_the_jax_bench(jax_line, port_run):
    line, _ = port_run
    assert {k: line[k] for k in COUNTERS} == {k: jax_line[k] for k in COUNTERS}
    assert line["valid_frames"] == N_FRAMES
    assert line["reint_frames_timed"] > 0
    assert set(line["stage_dev_ms"]) == set(jax_line["stage_dev_ms"])


def test_ate_within_tolerance_of_the_jax_bench(jax_line, port_run):
    line, _ = port_run
    assert abs(line["ate_rmse_cm"] - jax_line["ate_rmse_cm"]) < ATE_TOL_CM
    assert line["ate_rmse_cm"] < 10.0


def test_asynchronous_jax_bench_reintegrates_no_more(jax_lines, port_run):
    """``bench.py`` as its users run it: its packs land later, so its
    re-integration counters are at most the port's; the frames, dropped
    pairs and the ATE agree as in the synchronous comparison."""
    line, _ = port_run
    jax_async = jax_lines["async"]
    assert {k: jax_async[k] for k in EXACT} == {k: line[k] for k in EXACT}
    assert all(jax_async[k] <= line[k] for k in REINT), {
        k: (jax_async[k], line[k]) for k in REINT}
    assert abs(line["ate_rmse_cm"] - jax_async["ate_rmse_cm"]) < ATE_TOL_CM


def test_replay_leaves_the_engine_as_it_was(port_run):
    """The replay's stub of ``_build_reintegrate_rows`` is undone and
    ``profile_every`` is off again; the replay sampled both TSDF paths."""
    line, eng = port_run
    assert eng.profile_every == 0
    assert eng._build_reintegrate_rows.__func__ is BundleFusion._build_reintegrate_rows
    assert {"dev_tsdf", "dev_tsdf_rows", "dev_frame_step"} <= set(line["stage_dev_ms"])
    assert line["kernel_launches"] == {"tsdf_prepare": 0, "tsdf_cull": 0, "tsdf_apply": 0,
                                       "kabsch_filter": 0, "surface_area": 0}
    assert line["link_1p5mb_ms"] == [None, None] and line["peak_mem_gb"] is None


def test_card_configuration_is_bench_pys_operating_point():
    """``configure`` on the card (no card is needed to build it)."""
    intr, app, bundling, sift_cfg, g, windows = bench.configure(torch.device("cuda"))
    assert (intr.width, intr.height) == (640, 480)
    assert (app.hash_num_sdf_blocks, app.hash_key_capacity, app.visible_blocks_cap) == (
        131072, 131072, 8192)
    assert bundling.max_global_corr == 16384 and sift_cfg.target_keys == 150 and g == 64
    assert (windows.n_frames, windows.warmup_frames, windows.profile_frames,
            windows.stream_frames, windows.total) == (72, 12, 16, 20, 108)


def test_main_prints_one_json_line_last(capsys):
    out = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    parsed = []
    for text in lines:
        try:
            parsed.append(json.loads(text))
        except ValueError:
            pass
    assert parsed == [json.loads(lines[-1])]
    assert parsed[0] == json.loads(json.dumps(out))
    assert out["platform"] == "cpu" and out["total_frames"] == N_FRAMES
    assert out["valid_frames"] == N_FRAMES and out["sequence_s"] > 0


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
