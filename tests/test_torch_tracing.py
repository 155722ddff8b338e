"""The engine's span records and counters on the CPU (``trace`` /
``spans`` / ``counters``, ``utils/timing.py``).

The small configuration of ``tests/test_torch_engine.py`` with submaps of 4:
13 frames, three boundaries (frames 4, 8 and 12; the last two with the
global solve and its prune rounds), run once traced and once not, with the
TSDF dispatch on the culled path's plain stages (the card's path, so the
rows counter counts). Tracing must change nothing the engine computes or
reads: the same poses bit for bit and the same counted host reads. Each
boundary's span holds exactly the reads ``boundary_stats`` counts for it,
its Gauss-Newton steps lie within the solver's cap, the rows counter equals
the rows the cull listed, the local solve counts its eager run and its
steps, and with profiler ranges on the spans appear in a
``torch.profiler`` run as ``bf.<name>``. A traced solve counts its steps by
linear kind, LU or PCG, and the PCG iterations it enqueued.
"""

import numpy as np
import pytest
import torch

import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, make_sequence_wire
from bundlefusion_tpu_torch.pipeline import online
from bundlefusion_tpu_torch.pipeline.online import BundleFusion
from bundlefusion_tpu_torch.tsdf import apply_ops
from bundlefusion_tpu_torch.utils import host_reads, timing
from tests.torch_parity import APP, BUNDLING, SIFT

N_FRAMES = 13
PROFILED = (7, 8)   # an ordinary frame and a boundary under torch.profiler


def _run(traced: bool, monkeypatch):
    listed = []

    def cull(*args):
        rows, masks, n_rows = apply_ops._cull_plain(*args)
        listed.append(int(n_rows))
        return rows, masks, n_rows

    stages = (apply_ops.pack_images, cull, apply_ops._launch_plain)
    monkeypatch.setattr(online, "apply_tsdf_ops", lambda table, *a, rows_swept=None:
                        apply_ops._apply_culled(table, *a, stages, rows_swept))
    seq = make_sequence_wire(N_FRAMES, intr=default_intrinsics(160, 120))
    eng = BundleFusion(default_intrinsics(160, 120), port.AppConfig(**APP),
                       port.BundlingConfig(**dict(BUNDLING, submap_size=4)),
                       sift_cfg=port.SiftConfig(**SIFT), max_keyframes=8, device="cpu")
    listed.clear()
    reads0 = host_reads["count"]
    if traced:
        eng.trace(True, profiler_ranges=True)
    poses, profiled = [], []
    for f in range(N_FRAMES):
        if traced and f == PROFILED[0]:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
            prof.start()
        out = eng.process_frame(eng.upload_frame(seq["depth"][f], seq["color"][f]))
        poses.append((out["pose"].clone(), out["valid"].clone()))
        if traced and f == PROFILED[-1]:
            prof.stop()
            profiled = [e.name for e in prof.events()]
    spans = eng.spans()
    if traced:
        eng.trace(False)
    reads = host_reads["count"] - reads0
    return {"eng": eng, "poses": poses, "spans": spans, "reads": reads,
            "listed": sum(listed), "profiled": profiled}


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    try:
        return _run(True, mp), _run(False, mp)
    finally:
        mp.undo()


def test_tracing_changes_no_pose_and_no_read(runs):
    on, off = runs
    for (a, av), (b, bv) in zip(on["poses"], off["poses"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.equal(av, bv)
    np.testing.assert_array_equal(on["eng"].trajectory(), off["eng"].trajectory())
    assert on["reads"] == off["reads"] > 0
    keys = ("g", "prune_rounds", "host_reads")
    assert ([{k: s[k] for k in keys} for s in on["eng"].boundary_stats]
            == [{k: s[k] for k in keys} for s in off["eng"].boundary_stats])
    assert off["spans"] == [] and timing.active() is None
    assert all(s["span_ms"] is None for s in off["eng"].boundary_stats)


def test_each_boundary_span_holds_its_reads_and_gauss_newton_steps(runs):
    eng, spans = runs[0]["eng"], runs[0]["spans"]
    bounds = [s for s in spans if s["name"] == "boundary"]
    stats = eng.boundary_stats
    assert [s["frame"] for s in bounds] == [4, 8, 12] and [s["g"] for s in stats] == [0, 1, 2]
    b = eng.bundling
    cap = eng.local_solver.num_gn + eng.global_solver.num_gn * (1 + b.max_prune_rounds)
    for span, st in zip(bounds, stats):
        assert span["counters_incl"]["reads"] == st["host_reads"]
        assert st["span_ms"] == pytest.approx(1e-6 * (span["t1_ns"] - span["t0_ns"]))
        assert st["wait_ms"] == pytest.approx(1e-6 * span["wait_incl_ns"])
        assert 0 <= st["wait_ms"] <= st["span_ms"]
        assert 1 <= st["gn_steps"] == span["counters_incl"]["gn_steps"] <= cap
        # at N <= 2048 every Gauss-Newton step is one LU
        assert span["counters_incl"]["lu_steps"] == st["gn_steps"]
        assert "pcg_steps" not in span["counters_incl"]
    # the later boundaries solve the keyframe graph too
    assert stats[1]["gn_steps"] > stats[0]["gn_steps"]


def test_span_tree_of_each_frame(runs):
    spans = runs[0]["spans"]
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [s["frame"] for s in roots if s["name"] == "process_frame"] == list(range(N_FRAMES))
    assert [s["frame"] for s in roots if s["name"] == "upload_frame"] == list(range(N_FRAMES))
    assert {s["name"] for s in roots} == {"process_frame", "upload_frame"}
    for s in spans:
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"] and p["frame"] == s["frame"]
    names = {s["name"] for s in spans}
    assert {"time_frame_step", "time_re_integrate", "time_visualize", "reint_schedule",
            "time_submap_step", "time_submap_local_solve", "time_submap_global_solve",
            "pack_read", "retire_one", "push_optimized"} <= names
    assert "graph_launch" not in names   # the CPU replays no graph
    for s in spans:
        if s["name"] in ("reint_schedule", "garbage_collect"):
            assert by_id[s["parent"]]["name"] == "time_re_integrate"
        if s["name"] in ("pack_read", "retire_one", "push_optimized"):
            assert by_id[s["parent"]]["name"] == "time_solve"
        if s["name"] == "pack_read":
            assert s["counters"] == {"reads": 1}


def test_rows_counter_and_staleness(runs):
    on, off = runs
    counts = on["eng"].counters()
    assert counts["frames"] == N_FRAMES
    assert counts["tsdf_rows"] == on["listed"] > 0
    assert off["listed"] == on["listed"]
    assert on["eng"].reint_frames > 0
    assert counts["reintegrated"] == len(on["eng"].reint_lags) > 0
    assert counts["lag_frames_max"] >= counts["lag_frames_mean"] >= 1
    assert counts["backlog"] >= 0


def test_local_solve_counts_its_path_and_its_steps(runs):
    """On the CPU every boundary's local solve runs eagerly (one
    ``local_eager_solves``, no replay) and enqueues all its Gauss-Newton
    steps, each an LU, reading nothing back; ``local_gn_taken``, counted on
    the device, holds the steps whose update was applied, one or two a
    boundary, traced or not."""
    on, off = runs
    eng = on["eng"]
    n = eng.local_solver.num_gn
    local = [s for s in on["spans"] if s["name"] == "time_submap_local_solve"]
    assert len(local) == len(eng.boundary_stats) == 3
    for s in local:
        assert s["counters_incl"] == {"local_eager_solves": 1, "gn_steps": n, "lu_steps": n}
    taken = eng.counters()["local_gn_taken"]
    assert len(local) <= taken <= n * len(local)
    assert int(off["eng"]._local_gn_taken) == int(eng._local_gn_taken) == taken


def test_profiler_ranges_name_the_spans(runs):
    profiled = runs[0]["profiled"]
    for name in ("process_frame", "upload_frame", "time_frame_step", "boundary",
                 "time_submap_local_solve", "pack_read"):
        assert timing.PROFILER_PREFIX + name in profiled, name


@pytest.mark.parametrize("linear", ["dense", "pcg"])
def test_solver_counts_its_steps_by_kind(linear):
    """One traced ``solve_sparse`` of a perturbed pose graph: each
    Gauss-Newton step is one LU or one PCG solve, and the PCG iterations
    enqueued lie within the cap, read from the host's own loop counters."""
    import jax.numpy as jnp

    from bundlefusion_tpu.geometry import matrix_to_pose
    from bundlefusion_tpu_torch.solver import gn_pcg
    from tests.test_solver import build_pose_graph
    from tests.torch_parity import port_corrs, to_np

    rng = np.random.default_rng(0)
    gt, store = build_pose_graph(rng)
    init = np.stack([to_np(matrix_to_pose(jnp.asarray(g))) for g in gt]).astype(np.float32)
    init[1:] += rng.normal(size=(len(gt) - 1, 6)).astype(np.float32) * 0.05
    params = gn_pcg.SolverParams(linear=linear, num_gn=5, num_pcg=50)
    log = timing.TimingLog()
    reads0 = host_reads["count"]
    log.trace(True)
    try:
        with log.span("solve"):
            gn_pcg.solve_sparse(torch.from_numpy(init), torch.ones(len(gt), dtype=torch.bool),
                                port_corrs(store), params)
    finally:
        log.trace(False)
    (rec,) = log.spans()
    c = rec["counters"]
    assert 1 <= c["gn_steps"] <= params.num_gn
    assert c["reads"] == host_reads["count"] - reads0
    if linear == "dense":
        assert c["lu_steps"] == c["gn_steps"] and "pcg_steps" not in c
    else:
        assert c["pcg_steps"] == c["gn_steps"] and "lu_steps" not in c
        assert c["gn_steps"] <= c["pcg_iters"] <= params.num_pcg * c["gn_steps"]
