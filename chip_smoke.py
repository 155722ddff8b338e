#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Runs the port's main path (``bundlefusion_tpu_torch``) at the engine's
default, full-width configuration (``AppConfig()`` / ``BundlingConfig()``:
640x480 input and SIFT, 320x240 integration, 1 cm voxels, 200 064 payload
rows, 262 144 keys, windows of 11 frames, 150 keys, 128 raw matches, an
80x60 dense cache):

1. build: compile every CUDA kernel from the sources in this checkout;
2. kernels: hold each of the three kernels of the fused TSDF op (image
   pass, cull, sweep) and the op as a whole against the plain PyTorch
   versions on the card at the main path's shapes (1 op / 1 image and
   11 ops / 6 images), show that one call of the op waits for nothing, and
   time everything in turns; then the greedy Kabsch filter's kernel against
   its plain version (``kabsch_filter_ref``) on the real matches of the first
   window's 11 frames: the last frame's call (10 pairs of 128 raw matches),
   the window's 55 pairs as a global match of 64 and, cycled the same way,
   of 640 (the widest global match the repository drives): validity, counts and
   masks equal (on a pair that the plain version itself decides differently
   on the card and on the CPU, float32 rounding decides it, and the kernel
   must give one of its two answers), transforms within 1e-4, two calls
   bit for bit, one call waiting for nothing, times in turns; then the
   surface-area filter's kernel against its plain version
   (``surface_area_filter_ref``) on the same inputs with the greedy kernel's
   inlier masks, at 10, 64 and 640 pairs: areas within 1e-5 or 1e-4
   relative and keep flags equal (where an image's eigengap is under 1e-3
   the reference is ill-posed and either answer stands), two calls bit for
   bit, one call waiting for nothing, times in turns, and a batched
   ``torch.linalg.eigh`` of the same covariances beside them;
3. slice: drive the engine over 40 synthetic frames at poses with 1 cm of
   noise, pushing the noise-free poses after frames 10, 20 and 30 (as
   submap retirements do) and at the end, then drain the re-integration
   queue and extract the mesh. The op is held against its plain version
   again at the engine's first 1-op and first 11-op dispatch (those two run
   eagerly; every other dispatch and render replays the fusion graphs);
4. profile: 20 more frames of the same loop under ``torch.profiler`` for the
   card's busy share;
5. frontend: the same 40 wire frames through the whole per-frame path in
   the order ``process_frame`` has it, with the engine estimating its own
   poses: ``_frame_step`` (archive, SIFT, stores, matching, the Kabsch ->
   surface-area -> dense-verify cascade, correspondences, chained pose) as
   ``process_frame`` runs it (``_run_frame_step``), then the TSDF dispatch
   and the render on the step's pose and validity on the card (the fusion
   programs), then this phase's bookkeeping, which reads the pose back; at
   every 10th frame the window rolls over and the chained pose becomes the
   new window's base. Five runs with one wait per frame, in turns: the step
   and the fusion replayed from their captured graphs (the checks), both
   run eagerly (the engine's private switches), eagerly with the greedy
   filter's plain version patched in (``_PlainKabsch``; the package has no
   switch), eagerly, and the graphs again: frame times, the host ms of the
   step, the dispatch and the render, the host waits per frame of the whole
   path (``set_sync_debug_mode("warn")``), launches. The flags must be
   equal in all five, the graph's and the eager run's chained poses, voxel
   tables and last renders equal bit for bit and their launches equal, and
   the graphs and the kernel's eager run must make no host wait. Then
   eagerly, with a wait around every stage, the plain filter and the
   kernel (stage times, the filter's host
   reads), then for the graphs, eager and plain each 5 frames of the step
   under the profiler (launches per frame, device ms, busy share; for the
   graphs also CUDA events around each replay) and 2 eager frames with a
   trace and an op counter per stage. It fails unless all 40
   frames are valid, the chained trajectory's ATE RMSE is under 0.10 m,
   the render at the last pose is within 2 voxels of the true depth, the
   table's invariants hold and no allocation failed;
6. engine: the same 40 wire frames through the public entry points only:
   ``BundleFusion(intr, AppConfig(), BundlingConfig())`` with the keyframe
   capacity of 1200 (a 7200 x 7200 reduced system, a 12 000-frame archive,
   262 144 global correspondences), ``warmup()``, ``upload_frame`` +
   ``process_frame`` (frame i + 1 uploads while frame i computes),
   ``finish()``, ``trajectory()``, ``extract_mesh()``. Four runs: one as a
   user calls it, with the op at the engine's first 1-op and first 11-op
   dispatch held against its plain version (frame times, every check); one
   with a wait around every stage (the boundary's split; the validity flags
   must repeat, and the line says whether the trajectory repeats bit for
   bit); one under a trace of the card alone (busy share over the run); one
   with every boundary under a trace and an op counter of its own (launches,
   device ms and dispatched ops per boundary, the kernels the boundaries
   spend most on). It
   fails unless all 40 frames are valid, the optimized trajectory's ATE RMSE
   is under 0.10 m, 4 submaps were dispatched and at least 3 keyframes are
   valid, a re-integration dispatch came out of the engine's own pose
   updates and equals its plain version, all four kernels were launched,
   the render at the last pose is within 2 voxels of the true depth, the
   table's invariants hold, no allocation failed and the mesh has more than
   10 000 triangles;
7. recorded: the recorded-scan path at the same width. The 40 wire frames
   are written as a ``.sens`` (raw colour, zlib depth, true poses) with the
   port's ``save_sens``; every depth frame is decoded by the native codec and
   by Python zlib (equal bit for bit, and equal to the wire frames); the CLI
   (``bundlefusion_tpu_torch.__main__.main([file, "--out", dir])``) runs on
   the file in this process: exit code 0, 40 of 40 frames valid, ATE RMSE
   under 0.10 m, the ``.sens`` it writes back holds ``trajectory()``, a mesh
   of more than 10 000 triangles; ``render`` (the raycast) at the last pose
   is within 2 voxels of the true depth, as the splat is; an engine with
   host paging (radius PAGE_RADIUS_M, a sweep every PAGE_EVERY frames) runs
   PAGE_FRAMES frames and a natural sweep must page blocks out; its
   paged-key array starts at PAGE_BLOCKED_CAP entries, the run outgrows it,
   and the fusion graphs must be captured again (``fusion_recaptures``); the same run
   saved midway with its host blocks, loaded and continued must equal the
   unbroken run bit for bit (trajectory, flags, host keys, payload by key);
   and the contract of ``tests/test_streaming_engine.py``: an engine paged
   out entirely, frame 0 invalidated and one dispatch, paged back, against a
   never-paged twin (after both collect their empty blocks: same keys,
   weights equal, sdf within 1e-6);
8. solver at width: ``solve_sparse`` on a ring graph of 1200 poses (every
   pose tied to its 3 predecessors by 16 correspondences, perturbed by
   0.01) with the direct and with the PCG linear step, by CUDA events, and
   the direct step's parts (sort, pair blocks, assembly, the LU alone
   beside its float32 bound). Both must reach 1e-3 of the initial cost;
9. mesh: the multi-device path on 2 ``gloo`` ranks on the card, started
   once by ``parallel.mesh.run_ranks`` (spawn; the kernels are built
   before): (a) ``solve_sparse_sharded`` on phase 8's ring graph against
   single-device ``solve_sparse(linear="pcg")`` (poses within 2e-3, cost
   down by 1e3, no pair dropped, the engine's chunk solver equal, ms per
   solve and bytes all-gathered per GN step); (b) ``make_sharded_apply`` at
   the default table, 100 032 rows per rank, at 11 ops and 1 op, gathered
   and held against the single-table op (weights equal, sdf / colour within
   1e-6), each rank launching the three kernels; (c) ``BundleFusion(...,
   mesh=)`` at ``AppConfig()`` / ``BundlingConfig()`` over the 40 frames
   through the public entry points: 40 of 40 valid, ATE under 0.10 m beside
   phase 6's, ``replicas_agree()`` after every boundary, per boundary the
   local phase, broadcast, ``match_chunk`` and sharded-solve ms (a wait
   around every stage of a boundary frame) and the bytes broadcast,
   frames/s, peak memory per rank;
10. capacity: the long-run path of ``bundlefusion_tpu_torch.scripts``, after
   the mesh phase: (a) ``scripts.drift_demo.main`` at its card configuration
   (640x480, 241 frames of an out-and-back loop with 0.5 % depth noise and a
   blackout one submap long, 64 keyframes, 131 072 blocks): its two checks
   (tracking lost in the blackout, more than 70 % of the frames after it
   valid again), table invariants clean, no allocation failure, its TSDF op
   held against its plain version at its first 1-op and 11-op dispatch; (b) ``scripts.profile_boundary.main`` at G = 640 with 25
   correspondences per pair (4 199 pairs, 104 975 rows): no pair dropped, a
   largest residual under 1e-3, the cost falling, each part's time; (c) the
   same problem presorted and solved with a working set of 1<<16 rows and
   4 096 pairs, below both of its sizes, on the card and on the CPU: the
   same ``dropped``, the same working set, poses within 1e-4 (the worst pair
   is reported: on this noise-free problem it is a pair at rounding level);
   (d) the demo's engine over its first 4 submaps with bogus
   correspondences between keyframes 1 and 0 appended after the second
   boundary (the third boundary's prune rounds must remove them), then
   keyframe 1 invalidated and queued (the fourth boundary must revalidate
   it): the engine's prune and revalidation branches, which the demo's
   clean runs never take; (e) the engine's fusion half, as in 3., over 120
   frames of one turn on the spot inside a walled room (the port's
   ``room_scene`` / ``pan_trajectory``) at the demo's card configuration,
   whose surface fills tens of thousands of the 131 072 blocks: the TSDF op
   held against its plain version, and timed beside it, at the first 1-op
   and multi-op dispatch once 20 000 rows are live, table invariants clean,
   no allocation failure, the render within 2 voxels;
11. bench: the port's bench command, ``python -m
   bundlefusion_tpu_torch.bench``, in a child process that loads its kernels
   itself (``kernels.build_all`` finds the libraries phase 1 built) and runs
   on its own at ``bench.py``'s operating point (640x480,
   131 072 blocks, 16 384 global correspondences, 64 keyframes, 108 frames:
   every frame uploaded before ``warmup``, 12 warm-up and 60 timed frames,
   16 replayed with a wait around every stage, 20 streamed, then
   ``finish(extra_solves=2)``). Four runs in turns: as it is (the frame
   step and the fusion replayed from their graphs), with both run eagerly,
   with the greedy filter's plain version (eager), as it is again. It fails unless
   every run but the plain one exits 0 on the card with 108 of 108 frames
   valid, no pair dropped, the ATE under 0.10 m and all five kernels
   launched, and the plain one keeps every frame valid.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, a
``{"slice": {...}}`` line, a ``{"frontend": {...}}`` line, an ``{"engine":
{...}}`` line (with ``solver_at_width`` inside), a ``{"recorded": {...}}``
line, a ``{"mesh": {...}}`` line, a ``{"capacity": {...}}`` line, a
``{"bench": {...}}`` line (the bench's own line) and last ``{"ok": true,
"device": {...}}``. ``launches`` in the kernels line counts the slice phase,
``launches_frontend`` the frontend phase's first run, ``launches_engine`` the
engine phase's first run, ``launches_recorded`` the whole recorded phase,
``launches_mesh`` rank 0's mesh engine run (c), ``launches_capacity`` the
drift demo run of the capacity phase, ``launches_large_table`` its run (e),
``launches_bench`` the bench's whole run (its own process, counted from 0);
the counts are set to 0 just before each. For ``kabsch_filter`` and
``surface_area``, whose main path is the per-frame path (the fusion half
runs no match), ``launches`` is the frontend phase's first run (the
graphs'), as ``launches_frontend``; a replay adds the launches its graph
captured; its ``ms`` /
``plain_ms`` (CUDA events, host enqueue included) and ``kernel_ms`` (the
profiler) are at 10 pairs, ``_64`` / ``_640`` at 64 / 640; ``longest_fits``
counts the fits of the pair with the most, ``us_per_fit`` is ``kernel_ms``
over them (the pairs run side by side, so the longest sets the time), and
``ptxas`` has each compiled kernel function's registers, stack and spills
as ``nvcc -Xptxas -v`` reports them; ``bound_ms`` counts the inputs
and outputs once and the fits these inputs need (counted by the plain
version on the CPU, pair by pair) at ``FLOP_PER_FIT`` and
``FLOP_PER_MASKED_MATCH``: the work is a serial chain of dependent fits per
pair, so the kernel sits far above it; ``mismatching_pairs`` counts pairs
unlike the plain version's on the card, ``plain_card_cpu_split_pairs``
those the plain version decides differently on the card and the CPU. For
``surface_area`` the same keys, ``eigh_ms`` (a batched
``torch.linalg.eigh`` of the pairs' 3x3 covariances, the library call for
the eigen part; ``library_ms`` is null: no one call computes the filter),
``ill_posed_images`` and a bound from ``FLOP_PER_AREA_MATCH`` /
``FLOP_PER_AREA_SOLVE``. ``large_table`` in the
``tsdf_apply`` entry has the op's ``ms`` / ``plain_ms`` by CUDA events at
run (e)'s checked dispatches, its live and changed rows, and the bound from
the changed rows. In
the engine line ``host_reads_per_boundary`` counts the device -> host reads
of each boundary (the pack's included), ``lu_zero_steps`` the direct solves
that failed and became no update. In
the kernels line every time is at 11 ops (``_1op``: at 1 op). ``kernel_ms``
is the kernel's own device time from the profiler's trace, launches back to
back (``kernel_ms_cold``: the payload rewritten before each launch, so the
rows come from device memory and not from L2); ``bound_ms`` is the least
time the card could take: the larger of bytes over 3.35 TB/s and operations
over 67 TFLOP/s, from this run's shapes, row list and masks. ``ms`` is by
CUDA events, host enqueue included: for ``tsdf_apply`` the engine's entry
point ``apply_tsdf_ops`` (all three kernels), ``plain_ms`` its plain version
``apply_tsdf_ops_ref``, ``launch_ms`` one bare launch of the sweep and
``enqueue_ms`` the host's time per call of the op over 100 calls back to
back; for
``tsdf_prepare`` and ``tsdf_cull`` one call of the launcher, ``plain_ms``
their plain versions. ``max_abs_err`` of ``tsdf_cull`` is the number of rows
that the full plain sweep changes and the list lacks. ``library_ms`` is null:
no single PyTorch call computes any of the four. Any failed phase raises
and exits non-zero; without CUDA it exits non-zero before doing anything.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

N_FRAMES = 40
PUSH_AFTER = (10, 20, 30)
SDF_ATOL = 1e-6   # sdf / colour: float32 rounding of the division; weight exact
REPS = 5
PROFILE_FRAMES = 20
FRONTEND_PROFILE_FRAMES = 5
ATE_MAX_M = 0.10
PAGE_FRAMES = 30      # frames of each paging run of phase_recorded
PAGE_EVERY = 3        # its sweep cadence (frames)
PAGE_RADIUS_M = 2.2   # its paging radius: pages out part of the synthetic scene
PAGE_BLOCKED_CAP = 1024  # its paged-key array's first size (over 1 000 blocks are paged)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, float32 outside the tensor cores
ROW_BYTES = 5 * 512 * 4     # sdf + weight + 3 colour channels of one payload row
FLOP_PER_VOXEL_OP = 40      # projection 18, two divisions, pixel 4, gate 4, update 12
FLOP_PER_CORNER = 30        # projection 18, two divisions, pixel 4, six min / max
EMPTY_KEY = 2**31 - 1
REPLACES = {
    "tsdf_prepare": "bundlefusion_tpu/tsdf/apply_pallas.py:620",
    "tsdf_cull": "bundlefusion_tpu/tsdf/apply_pallas.py:554",
    "tsdf_apply": "bundlefusion_tpu/tsdf/apply_pallas.py:104",
    "kabsch_filter": "bundlefusion_tpu/ops/filters.py:80",
    "surface_area": "bundlefusion_tpu/ops/filters.py:234",
}
TSDF_KERNELS = ("tsdf_prepare", "tsdf_cull", "tsdf_apply")  # the fused TSDF op's three
KABSCH_PAIRS = (10, 64, 640)  # the greedy filter: one frame's pairs, two global matches
KABSCH_T_ATOL = 1e-4        # kernel vs plain transforms (tests/test_torch_filters.py)
# operations of one greedy-filter fit, counted from the plain version's
# arithmetic: the 4x4 algebra (N, 7 squarings with their norms, q, R, t, the
# three 3x3 eigenvalue solves) once, and per masked match the weight, centroid,
# cross-covariance, covariance and residual terms
FLOP_PER_FIT = 1450
FLOP_PER_MASKED_MATCH = 110
# the surface-area filter, per image: per match (every one of the R, as the
# plain version's sums take them) the weight, the first and second moments,
# the plane projection and the box extents; per image two symmetric
# eigenproblems (3x3 and 2x2)
FLOP_PER_AREA_MATCH = 110
FLOP_PER_AREA_SOLVE = 1500
AREA_ATOL, AREA_RTOL = 1e-5, 1e-4   # kernel vs plain areas (tests/torch_surface_area_cases.py)
AREA_GAP_RTOL = 1e-3                # below it the reference is ill-posed


def _sync():
    torch.cuda.synchronize()


def _compare(a, b) -> float:
    """Max |a - b| over sdf and colour; raises unless weights are equal and
    sdf / colour agree within SDF_ATOL."""
    if not torch.equal(a.weight, b.weight):
        n = int((a.weight != b.weight).sum())
        raise AssertionError(f"kernel and plain weights differ at {n} voxels")
    err = max(float((a.sdf - b.sdf).abs().max()), float((a.color - b.color).abs().max()))
    if not err <= SDF_ATOL:
        raise AssertionError(f"kernel and plain sdf/colour differ by {err}")
    return err


def _depth_err(render_depth, seq, f):
    """(median |rendered depth - true depth| in m, pixels compared) at frame ``f``."""
    d = render_depth.cpu().numpy()
    step = seq["depth"].shape[1] // d.shape[0]
    gt_d = seq["depth"][f][::step, ::step].astype(np.float32) * 1e-3
    gt_d[gt_d == 0] = np.nan
    both = np.isfinite(d) & np.isfinite(gt_d)
    err = float(np.median(np.abs(d[both] - gt_d[both]))) if both.any() else float("inf")
    return err, int(both.sum())


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    _sync()
    return start.elapsed_time(end)


def _enqueue_ms(fn, n=100) -> float:
    """Host time per call of ``fn`` over ``n`` calls back to back, with no
    wait in between: what the call costs a caller that streams its work to
    the card."""
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    _sync()
    return ms


def _kernel_device_ms(fn, kernel, before=None):
    """Mean device time of ``kernel`` over REPS calls of ``fn`` (each after
    ``before()``, if given), from the profiler's trace of the card: the
    CUDA events around one call also time the host's enqueue, which is
    most of a call this short. A trace that misses the kernel (it happens
    now and then) is taken again, up to 3 times; None when none holds it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                if before is not None:
                    before()
                fn()
            _sync()
        hits = [e for e in prof.key_averages() if kernel in e.key]
        if hits:
            return sum(e.self_device_time_total for e in hits) / 1e3 / sum(e.count for e in hits)
    print(f"chip_smoke: no {kernel} in the profiler trace", file=sys.stderr)
    return None


def _ptxas(log: str) -> list:
    """Each kernel function's resources from ``nvcc -Xptxas -v`` output:
    [{"function", "registers", "stack_bytes", "spill_stores", "spill_loads"}]
    with the function's name demangled as far as ``name<K>``."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            z = re.match(r"_Z(\d+)", fn)
            name = fn[z.end():z.end() + int(z.group(1))] if z else fn
            k = re.match(r"ILi(\d+)E", fn[z.end() + int(z.group(1)):]) if z else None
            cur = {"function": f"{name}<{k.group(1)}>" if k else name}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def phase_build():
    """Builds and loads every kernel; returns (seconds, {name: ptxas list})."""
    from bundlefusion_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    for name in kernels.SOURCES:
        kernels.load(name)
    ptxas = {name: _ptxas(log) for name, log in kernels.build_logs.items()}
    for name, fns in ptxas.items():
        for f in fns:
            print(f"[build {name}] {json.dumps(f)}")
    return time.perf_counter() - t0, ptxas


def _restore(dst, src):
    dst.sdf.copy_(src.sdf)
    dst.weight.copy_(src.weight)
    dst.color.copy_(src.color)


def _bound(n_bytes: float, flop: float):
    """(least ms the card could take, which limit sets it)."""
    by_bytes, by_flop = n_bytes / HBM_BYTES_PER_S * 1e3, flop / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_flop), ("bytes" if by_bytes >= by_flop else "operations")


def _changed_rows(after, before):
    ch = torch.zeros(after.sdf.shape[0], dtype=torch.bool, device=after.sdf.device)
    for name in ("sdf", "weight", "color"):
        ch |= (getattr(after, name) != getattr(before, name)).any(dim=1)
    return ch


def phase_kernels(dev, seq, noisy, gt, app):
    """Kernels vs plain versions on the card at the main path's shapes."""
    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.config import BundlingConfig
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.tsdf import apply_ops
    from bundlefusion_tpu_torch.tsdf.integrate import candidate_keys
    from bundlefusion_tpu_torch.tsdf.table import allocate_packed

    eng = BundleFusion(seq["intrinsics"], app, BundlingConfig(),
                       max_keyframes=N_FRAMES // 10 + 2, device=dev)
    intr, params = eng.intr_int, eng.tsdf_params
    depths, colors = [], []
    for i in range(6):
        _, _, d, c = eng._archive_frame(seq["depth"][i], seq["color"][i], i)
        depths.append(d)
        colors.append(c)
        for T in (noisy[i], gt[i]):
            allocate_packed(eng.table, candidate_keys(d, intr, torch.as_tensor(T, device=dev), params))
    D, C = torch.stack(depths), torch.stack(colors)
    P_noisy = torch.as_tensor(noisy[:6], device=dev)
    P_gt = torch.as_tensor(gt[:6], device=dev)
    # base state: frames 0-4 fused at their noisy poses (plain version)
    base = eng.table
    apply_ops.apply_tsdf_ops_ref(base, D[:5], C[:5], P_noisy[:5], [1.0] * 5, list(range(5)),
                                 intr, params)

    batches = {
        # the fast path: the current frame's fuse
        "1op": (D[5:6].contiguous(), C[5:6].contiguous(), P_noisy[5:6], [1.0], [0]),
        # the rows path: 5 de/re rows (row 2 skipped: sign 0) + current frame
        "11op": (
            D, C,
            torch.cat([torch.stack([P_noisy[:5], P_gt[:5]], 1).reshape(10, 4, 4), P_noisy[5:6]]),
            [-1.0, 1.0, -1.0, 1.0, 0.0, 0.0, -1.0, 1.0, -1.0, 1.0, 1.0],
            [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5],
        ),
    }
    N = base.num_blocks
    wave = kernels.tsdf_apply_wave()
    out = {}
    work = base.clone()
    ref = base.clone()

    def restore():
        _restore(work, base)
        _restore(ref, base)

    for name, (d, c, p, signs_host, imgs_host) in batches.items():
        H, W = d.shape[1:]
        w2c = apply_ops.world_to_camera_rows(p)
        # the op table on the card, as the engine's fusion programs hand it over
        signs = torch.tensor(signs_host, dtype=torch.float32, device=dev)
        imgs = torch.tensor(imgs_host, dtype=torch.int32, device=dev)
        imgs_t = imgs.long()

        def run_kernel():
            apply_ops.apply_tsdf_ops(work, d, c, p, signs, imgs, intr, params)

        def run_plain():
            apply_ops.apply_tsdf_ops_ref(ref, d, c, p, signs, imgs, intr, params)

        # the op as a whole
        restore()
        run_kernel()
        run_plain()
        _sync()
        err = _compare(work, ref)
        changed = _changed_rows(ref, base)
        # one call of the op waits for nothing: any synchronising call raises
        _restore(work, base)
        _sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_kernel()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _sync()
        _compare(work, ref)

        # the image pass: bitwise
        packed, dmax = kernels.tsdf_prepare_launch(d, c)
        p_packed, p_dmax = apply_ops.pack_images(d, c)
        _sync()
        if not (torch.equal(packed.view(torch.int32), p_packed.view(torch.int32))
                and torch.equal(dmax, p_dmax)):
            raise AssertionError("tsdf_prepare and pack_images differ")
        prep_err = float((packed - p_packed).abs().max())

        # the cull: every row the full plain sweep changes is listed
        rows, masks, n_rows = kernels.tsdf_cull_launch(base, w2c, signs, imgs, dmax, intr,
                                                       params, H, W)
        p_rows, _ = apply_ops.active_block_rows(base, w2c, signs, intr, params, H, W,
                                                op_dmax=dmax[imgs_t])
        _sync()
        n = int(n_rows)
        in_list = torch.zeros(N + 1, dtype=torch.bool, device=dev)
        in_list[rows[:n].long()] = True
        in_plain = torch.zeros(N + 1, dtype=torch.bool, device=dev)
        in_plain[p_rows.long()] = True
        missed = int((changed & ~in_list).sum())
        if missed or int(in_list.sum()) != n:
            raise AssertionError(f"tsdf_cull: {missed} changed rows not listed, "
                                 f"{n - int(in_list.sum())} rows listed twice")
        row_ops = int(apply_ops.mask_bits(masks[:n], len(signs_host)).sum())
        live_rows = int((base.slot_keys[:-1] != EMPTY_KEY).sum())
        active = sum(1 for x in signs_host if x != 0.0)

        # the bare sweep on the kernel's list
        def run_launch(grid=0):
            kernels.tsdf_apply_launch(work, rows, masks, n_rows, packed, w2c, signs, imgs,
                                      intr, params, grid_ctas=grid)

        _restore(work, base)
        run_launch()
        _sync()
        err = max(err, _compare(work, ref))

        def run_prepare():
            kernels.tsdf_prepare_launch(d, c)

        def run_prepare_plain():
            apply_ops.pack_images(d, c)

        def run_cull():
            kernels.tsdf_cull_launch(base, w2c, signs, imgs, dmax, intr, params, H, W)

        def run_cull_plain():
            apply_ops.active_block_rows(base, w2c, signs, intr, params, H, W,
                                        op_dmax=dmax[imgs_t])

        # timing in turns, each run on a restored copy of the base state
        order = (run_plain, run_kernel, run_launch, run_prepare, run_prepare_plain,
                 run_cull, run_cull_plain)
        times = {fn: [] for fn in order}
        for r in range(REPS):
            for fn in order if r % 2 == 0 else order[::-1]:
                restore()
                _sync()
                times[fn].append(_event_ms(fn))
        med = {fn.__name__: statistics.median(v) for fn, v in times.items()}

        used_imgs = len({i for i, x in zip(imgs_host, signs_host) if x != 0.0})
        sample_bytes = H * W * 16
        out[name] = {
            "max_abs_err": err,
            "ms": med["run_kernel"],
            "plain_ms": med["run_plain"],
            "launch_ms": med["run_launch"],
            "enqueue_ms": _enqueue_ms(run_kernel),
            "kernel_ms": _kernel_device_ms(run_launch, "tsdf_apply_kernel"),
            "kernel_ms_cold": _kernel_device_ms(run_launch, "tsdf_apply_kernel", before=restore),
            # the persistent grid's size, in card-fulls of CTAs (cold rows)
            "grid_ms": {
                f"{k}x": _kernel_device_ms(lambda: run_launch(max(1, int(wave * k))),
                                           "tsdf_apply_kernel", before=restore)
                for k in (0.5, 1, 2, 4)
            },
            "bound": _bound(n * (2 * ROW_BYTES + 12) + used_imgs * sample_bytes,
                            row_ops * 512 * FLOP_PER_VOXEL_OP),
            "rows": n,
            "rows_plain": int(p_rows.shape[0]),
            "rows_both": int((in_list & in_plain).sum()),
            "rows_changed": int(changed.sum()),
            "live_rows": live_rows,
            "ops_per_row": row_ops / max(n, 1),
            "prepare": {
                "max_abs_err": prep_err,
                "ms": med["run_prepare"],
                "plain_ms": med["run_prepare_plain"],
                "kernel_ms": _kernel_device_ms(run_prepare, "tsdf_prepare_kernel"),
                "bound": _bound(len(d) * H * W * 32 + len(d) * 4, len(d) * H * W * 20),
            },
            "cull": {
                "max_abs_err": float(missed),
                "ms": med["run_cull"],
                "plain_ms": med["run_cull_plain"],
                "kernel_ms": _kernel_device_ms(run_cull, "tsdf_cull_kernel"),
                "bound": _bound(N * 4 + n * 12 + len(signs_host) * 64 + 4,
                                live_rows * active * 8 * FLOP_PER_CORNER),
            },
        }
    out["wave_ctas"] = wave
    del eng, base, work, ref
    torch.cuda.empty_cache()
    return out


def _fusion_launches_ok(launches, dispatches) -> bool:
    """The fusion half's launches: each TSDF kernel once per dispatch, and
    the two filters, which only the frontend runs, never."""
    from bundlefusion_tpu_torch import kernels

    return (dispatches > 0 and set(launches) == set(kernels.SOURCES)
            and all(launches[k] == dispatches for k in TSDF_KERNELS)
            and launches["kabsch_filter"] == launches["surface_area"] == 0)


def _filter_inputs(dev, seq, app, bundling, sift_cfg):
    """The greedy filter's inputs as ``_frame_step`` hands them over: the
    first window's 11 frames (frame f is matched against the f before it)
    at the engine's default configuration. Returns (the last frame's 10
    pairs, all 55 pairs pooled), each the five input tensors."""
    from bundlefusion_tpu_torch.config import BundlingConfig
    from bundlefusion_tpu_torch.pipeline import frontend
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    eng = BundleFusion(seq["intrinsics"], app, bundling or BundlingConfig(), sift_cfg=sift_cfg,
                       max_keyframes=N_FRAMES // 10 + 2, device=dev)
    calls, inner = [], frontend.kabsch_filter

    def capture(*args):
        calls.append([a.clone() for a in args[:5]])
        return inner(*args)

    frontend.kabsch_filter = capture
    try:
        for f in range(eng.S):
            eng._frame_step(seq["depth"][f], seq["color"][f], f, eng._store_slot(f))
    finally:
        frontend.kabsch_filter = inner
    del eng
    torch.cuda.empty_cache()
    if [c[4].shape[0] for c in calls] != list(range(1, KABSCH_PAIRS[0] + 1)):
        raise AssertionError(f"frame_step handed the filter {[c[4].shape for c in calls]}")
    return calls[-1], [torch.cat([c[i] for c in calls]) for i in range(5)]


def _same_pairs(a, b):
    """Per pair of two filter results: validity, count and mask equal."""
    return ((a["valid_pair"] == b["valid_pair"]) & (a["count"] == b["count"])
            & (a["inlier_mask"] == b["inlier_mask"]).all(-1))


def _kabsch_work(args):
    """(fits, masked matches summed over the fits) that each pair of
    ``args`` needs: the plain version run on one pair at a time on the CPU,
    counting its fits by their covariance call, which gets the fit's mask."""
    from bundlefusion_tpu_torch.ops import filters

    inner, seen = filters._weighted_cov, []

    def counted(pts, w):
        seen.append(float(w[0].sum()))
        return inner(pts, w)

    host = [a.cpu() for a in args]
    work = []
    filters._weighted_cov = counted
    try:
        for p in range(host[0].shape[0]):
            seen.clear()
            filters.kabsch_filter_ref(*(a[p:p + 1] for a in host))
            work.append((len(seen), sum(seen)))
    finally:
        filters._weighted_cov = inner
    return work


def phase_kabsch(dev, seq, app, bundling=None, sift_cfg=None):
    """The greedy Kabsch filter's kernel against its plain version on the
    card, on real matches of the first window at 10 pairs (one frame's call),
    64 and 640 (the pool cycled, as a global match at G = 64 / 640 has it): every pair's
    validity, count and mask equal the plain version's on the card (or, on
    a pair that the plain version decides differently on the card and on
    the CPU, its CPU answer) and transforms within KABSCH_T_ATOL,
    two calls equal bit for bit, one call waiting for nothing; then times
    in turns and the bound from the work these inputs need. ``bundling`` /
    ``sift_cfg`` default to the engine's."""
    from bundlefusion_tpu_torch.ops import filters

    args_fp = (25, 4, 4e-4)
    last, pool = _filter_inputs(dev, seq, app, bundling, sift_cfg)
    n_pool = pool[0].shape[0]
    work = _kabsch_work(pool)
    out = {}
    for pairs in KABSCH_PAIRS:
        if pairs == KABSCH_PAIRS[0]:
            args, rows = last, list(range(n_pool - pairs, n_pool))
        else:
            rows = [i % n_pool for i in range(pairs)]
            args = [a[rows].contiguous() for a in pool]

        def run_kernel():
            return filters.kabsch_filter(*args, *args_fp)

        def run_plain():
            return filters.kabsch_filter_ref(*args, *args_fp)

        got, want = run_kernel(), run_plain()
        cpu = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in
               filters.kabsch_filter_ref(*(a.cpu() for a in args), *args_fp).items()}
        _sync()
        # a pair that the plain version decides one way on the card and
        # another on the CPU is decided by float32 rounding: there the
        # kernel must give one of the two answers
        split = ~_same_pairs(want, cpu)
        as_card, as_cpu = _same_pairs(got, want), _same_pairs(got, cpu)
        bad = ~(as_card | (split & as_cpu))
        t_err = max(float((got["transform"] - ref["transform"]).abs().amax((-1, -2))[same]
                          .max()) if bool(same.any()) else 0.0
                    for same, ref in ((as_card, want), (~as_card, cpu)))
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = run_kernel()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _sync()
        repeat = (all(torch.equal(got[k], again[k])
                      for k in ("valid_pair", "count", "inlier_mask"))
                  and torch.equal(got["transform"].view(torch.int32),
                                  again["transform"].view(torch.int32)))
        if int(bad.sum()) or not t_err <= KABSCH_T_ATOL or not repeat:
            raise AssertionError(f"kabsch_filter at {pairs} pairs: pairs "
                                 f"{bad.nonzero().flatten().tolist()} differ from the plain "
                                 f"version (card / CPU split: "
                                 f"{split.nonzero().flatten().tolist()}), transforms by "
                                 f"{t_err}, two calls equal: {repeat}")
        times = {run_kernel: [], run_plain: []}
        order = (run_plain, run_kernel)
        for r in range(REPS):
            for fn in order if r % 2 == 0 else order[::-1]:
                _sync()
                times[fn].append(_event_ms(fn))
        R = args[4].shape[1]
        fits = sum(work[i][0] for i in rows)
        longest = max(work[i][0] for i in rows)
        masked = sum(work[i][1] for i in rows)
        kernel_ms = _kernel_device_ms(run_kernel, "kabsch_filter_kernel")
        out[str(pairs)] = {
            "pairs": pairs,
            "raw_matches": int(args[4].sum()),
            "valid_pairs": int(want["valid_pair"].sum()),
            "inliers": int(want["count"].sum()),
            "fits": fits,
            "longest_fits": longest,
            "mismatching_pairs": int((~as_card).sum()),   # against the plain on the card
            "plain_card_cpu_split_pairs": int(split.sum()),
            "max_abs_err": t_err,
            "ms": statistics.median(times[run_kernel]),
            "plain_ms": statistics.median(times[run_plain]),
            "plain_host_reads": want["host_reads"],
            "kernel_ms": kernel_ms,
            "us_per_fit": kernel_ms * 1e3 / longest if kernel_ms and longest else None,
            # inputs once (points, pixels, valid), outputs once (mask,
            # count, transform, valid_pair); the fits these inputs need
            "bound": _bound(pairs * R * (4 * 10 + 1 + 1) + pairs * (8 + 64 + 1),
                            fits * FLOP_PER_FIT + masked * FLOP_PER_MASKED_MATCH),
        }
    return out


def _ill_posed(pts, mask):
    """[P] bool: an image whose 3x3 covariance has its two smallest
    eigenvalues, or whose plane's 2x2 covariance its two, within
    AREA_GAP_RTOL of each other (relative to the largest): its plane or box
    axes are not defined by the points, and any area is an answer
    (tests/torch_surface_area_cases.py)."""
    out = np.zeros(len(pts), bool)
    for p, (x, m) in enumerate(zip(pts.astype(np.float64), mask)):
        w = m & np.isfinite(x).all(-1)
        if w.sum() < 2:
            continue
        c = x[w] - x[w].mean(0)
        lam, vec = np.linalg.eigh(c.T @ c / len(c))
        if lam[2] <= 0:
            continue
        if lam[1] - lam[0] < AREA_GAP_RTOL * lam[2]:
            out[p] = True
            continue
        q = c @ vec[:, [2, 1]]
        mu = np.linalg.eigvalsh(q.T @ q / len(c))
        out[p] = mu[1] - mu[0] < AREA_GAP_RTOL * mu[1]
    return out


def phase_surface_area(dev, seq, app, bundling=None, sift_cfg=None):
    """The surface-area filter's kernel against its plain version on the
    card, on the real inputs of the first window (the raw matches' points
    and the greedy kernel's inlier masks) at 10 pairs (one frame's call), 64
    and 640 (the pool cycled): areas within AREA_ATOL or AREA_RTOL and keep
    flags equal where the reference is well-posed, two calls equal bit for
    bit, one call waiting for nothing; then times in turns with the plain
    version, the kernel's device time, a batched ``torch.linalg.eigh`` of
    the same covariances (the library call for its eigen part) and the
    bound."""
    from bundlefusion_tpu_torch.ops import filters

    thresh = 0.032
    last, pool = _filter_inputs(dev, seq, app, bundling, sift_cfg)
    n_pool = pool[0].shape[0]
    out = {}
    for pairs in KABSCH_PAIRS:
        raw = last if pairs == KABSCH_PAIRS[0] else [
            a[[i % n_pool for i in range(pairs)]].contiguous() for a in pool]
        kf = filters.kabsch_filter(*raw, 25, 4, 4e-4)
        args = (raw[0], raw[1], kf["inlier_mask"])

        def run_kernel():
            return filters.surface_area_filter(*args, thresh)

        def run_plain():
            return filters.surface_area_filter_ref(*args, thresh)

        got, want = run_kernel(), run_plain()
        _sync()
        g = [x.cpu().numpy() for x in got]
        w = [x.cpu().numpy() for x in want]
        src, tgt, mask = (a.cpu().numpy() for a in args)
        skips = (_ill_posed(src, mask), _ill_posed(tgt, mask))
        bad = np.zeros(pairs, bool)
        undecided = np.zeros(pairs, bool)
        err = 0.0
        for ga, wa, skip in zip(g[1:], w[1:], skips):
            e = np.abs(ga - wa)
            bad |= ~((e <= AREA_ATOL) | (e <= AREA_RTOL * np.abs(wa)) | skip)
            err = max(err, float(e[~skip].max()) if (~skip).any() else 0.0)
            undecided |= skip & ((ga >= thresh) | (wa >= thresh))
        bad |= (g[0] != w[0]) & ~undecided
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = run_kernel()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _sync()
        repeat = torch.equal(got[0], again[0]) and all(
            torch.equal(x.view(torch.int32), y.view(torch.int32))
            for x, y in zip(got[1:], again[1:]))
        if bad.any() or not repeat:
            raise AssertionError(f"surface_area at {pairs} pairs: pairs "
                                 f"{np.flatnonzero(bad).tolist()} differ from the plain version "
                                 f"(kernel {[x[bad].tolist() for x in g]}, plain "
                                 f"{[x[bad].tolist() for x in w]}); two calls equal: {repeat}")
        # the eigen part as one library call: the covariances of both images
        wts = torch.cat([args[2], args[2]]).to(torch.float32)
        pts = torch.cat([args[0], args[1]])
        wts = torch.where(torch.isfinite(pts).all(-1), wts, 0.0)
        covs = filters._weighted_cov(torch.where(wts[..., None] > 0, pts, 0.0), wts)
        times = {run_kernel: [], run_plain: []}
        order = (run_plain, run_kernel)
        for r in range(REPS):
            for fn in order if r % 2 == 0 else order[::-1]:
                _sync()
                times[fn].append(_event_ms(fn))
        eigh_ms = statistics.median(_event_ms(lambda: torch.linalg.eigh(covs))
                                    for _ in range(REPS))
        R = mask.shape[1]
        out[str(pairs)] = {
            "pairs": pairs,
            "inliers": int(mask.sum()),
            "kept_pairs": int(g[0].sum()),
            "ill_posed_images": int(skips[0].sum() + skips[1].sum()),
            "mismatching_pairs": int(bad.sum()),
            "max_abs_err": err,
            "ms": statistics.median(times[run_kernel]),
            "plain_ms": statistics.median(times[run_plain]),
            "kernel_ms": _kernel_device_ms(run_kernel, "surface_area_kernel"),
            "eigh_ms": eigh_ms,
            "eigh_batch": list(covs.shape),
            # inputs once (two point sets, the mask), outputs once (keep, two
            # areas); every match of both images and their eigenproblems
            "bound": _bound(pairs * R * (12 + 12 + 1) + pairs * (1 + 4 + 4),
                            2 * pairs * (R * FLOP_PER_AREA_MATCH + FLOP_PER_AREA_SOLVE)),
        }
    return out


def _live_rows(table) -> int:
    return int((table.slot_keys[:-1] != EMPTY_KEY).sum())


class _CheckedApply:
    """Wraps the engine's fusion programs (``_run_fusion``): counts the
    TSDF dispatches and, at the first fast and the first rows dispatch,
    runs that dispatch eagerly and holds the kernels' result against the
    plain version run on a snapshot taken right before the op. Every other
    dispatch, and every render, runs as the engine runs it (on the card, a
    replay of the captured graph). With ``min_rows`` it checks the first of
    each once the table holds that many live rows, and there also times the
    op and its plain version (CUDA events) and counts the rows the op
    changed, for the bound: each changed row read and written once, every
    op on every changed row."""

    def __init__(self, eng, min_rows=None):
        self.eng = eng
        self.inner = eng._run_fusion
        self.min_rows = min_rows
        self.dispatches = 0
        self.checked = {}

    def __call__(self, name):
        if name == "render":
            return self.inner(name)
        self.dispatches += 1
        if name in self.checked or (self.min_rows is not None
                                    and _live_rows(self.eng.table) < self.min_rows):
            return self.inner(name)
        eng = self.eng
        apply = eng._apply_tsdf_ops
        eng._apply_tsdf_ops = lambda *args: self._check(name, apply, args)
        try:
            eng._fusion_body(name)  # eagerly: the check reads the card
        finally:
            del eng._apply_tsdf_ops  # the method again
        return None

    def _check(self, kind, apply, args):
        from bundlefusion_tpu_torch.tsdf.apply_ops import apply_tsdf_ops_ref

        eng = self.eng
        poses, signs = args[2], args[3]
        snap = eng.table.clone()
        entry = {"frame": eng.frame_idx, "ops": int(poses.shape[0])}

        def plain():
            apply_tsdf_ops_ref(snap, *args, eng.intr_int, eng.tsdf_params)

        if self.min_rows is None:
            apply(*args)
            plain()
            _sync()
        else:
            before = snap.clone()
            entry["ms"] = _event_ms(lambda: apply(*args))
            entry["plain_ms"] = _event_ms(plain)
            changed = int(_changed_rows(eng.table, before).sum())
            del before
            n_ops = int((signs != 0).sum())
            entry.update(live_rows=_live_rows(eng.table), rows_changed=changed,
                         bound=_bound(changed * 2 * ROW_BYTES,
                                      changed * n_ops * 512 * FLOP_PER_VOXEL_OP))
        entry["max_abs_err"] = _compare(eng.table, snap)
        self.checked[kind] = entry
        del snap


def _check_apply(eng, min_rows=None) -> _CheckedApply:
    """Attach a :class:`_CheckedApply` to ``eng``; returns it."""
    checker = _CheckedApply(eng, min_rows)
    eng._run_fusion = checker  # the instance attribute shadows the method
    return checker


def _drive_frame(eng, seq, noisy, gt, i, stage, push_after=PUSH_AFTER):
    """Frame ``i`` of the fusion half, each stage run through
    ``stage(name, fn)``; the noise-free poses are pushed after the frames
    of ``push_after``, as submap retirements do."""
    eng.frame_idx = i
    slot = eng._store_slot(i)
    stage("archive", lambda: eng._archive_frame(seq["depth"][i], seq["color"][i], slot))
    stage("tsdf", lambda: eng._tsdf_dispatch(slot, noisy[i], True))
    eng._record_frame(i, noisy[i], True)
    stage("render", lambda: eng._render_frame(i, noisy[i]))
    if i in push_after:
        eng.complete_traj = [gt[f].copy() for f in range(len(eng.complete_traj))]
        eng._push_optimized_to_manager()


def phase_profile(dev, seq, noisy, gt, app):
    """The last PROFILE_FRAMES frames of the same loop under the profiler:
    wall and device time per frame, the card's busy share, the kernels
    that hold most of the device time, and the three TSDF kernels' mean
    device time on the main path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bundlefusion_tpu_torch.config import BundlingConfig
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    eng = BundleFusion(seq["intrinsics"], app, BundlingConfig(),
                       max_keyframes=N_FRAMES // 10 + 2, device=dev)
    first = N_FRAMES - PROFILE_FRAMES
    for i in range(first):
        _drive_frame(eng, seq, noisy, gt, i, lambda _name, fn: fn())
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, N_FRAMES):
            _drive_frame(eng, seq, noisy, gt, i, lambda _name, fn: fn())
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # events of the card only: a host op's entry repeats its kernels' time
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in evs) / 1e3
    if not device_ms > 0:
        raise AssertionError("the profiler's trace holds no device time")
    evs.sort(key=lambda e: -e.self_device_time_total)
    return {
        "frames": PROFILE_FRAMES,
        "wall_ms_per_frame": wall_ms / PROFILE_FRAMES,
        "device_ms_per_frame": device_ms / PROFILE_FRAMES,
        "device_busy_share": device_ms / wall_ms,
        "top_device_ms": [[e.key[:80], e.self_device_time_total / 1e3] for e in evs[:8]],
        "tsdf_kernel_ms": {
            e.key.split("(")[0]: e.self_device_time_total / 1e3 / e.count
            for e in evs if e.key.startswith("tsdf_")
        },
    }


def phase_slice(dev, seq, noisy, gt, app):
    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.config import BundlingConfig
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.tsdf.table import check_invariants

    eng = BundleFusion(seq["intrinsics"], app, BundlingConfig(),
                       max_keyframes=N_FRAMES // 10 + 2, device=dev)
    checker = _check_apply(eng)
    stages = {"archive": [], "tsdf_fast": [], "tsdf_rows": [], "render": []}

    def timed(fn):
        _sync()
        t0 = time.perf_counter()
        r = fn()
        _sync()
        return r, (time.perf_counter() - t0) * 1e3

    def stage(name, fn):
        rows_before, checked_before = eng.reint_frames, len(checker.checked)
        _, ms = timed(fn)
        if name == "tsdf":
            if len(checker.checked) != checked_before:  # skip frames that ran a check
                return
            name = "tsdf_rows" if eng.reint_frames > rows_before else "tsdf_fast"
        stages[name].append(ms)

    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    t_start = time.perf_counter()
    for i in range(N_FRAMES):
        _drive_frame(eng, seq, noisy, gt, i, stage)
    eng.frame_idx = N_FRAMES
    # finish(): the final optimized trajectory, then the drain
    eng.complete_traj = [gt[f].copy() for f in range(N_FRAMES)]
    eng._push_optimized_to_manager()
    eng._drain_reintegration()
    _sync()
    loop_s = time.perf_counter() - t_start
    launches = dict(kernels.launch_counts)

    inv = check_invariants(eng.table)
    fails = int(eng.table.num_alloc_failures)
    (verts, _), mesh_ms = timed(eng.extract_mesh)
    med_err, hit = _depth_err(eng._render(eng.table, gt[N_FRAMES - 1])["depth"], seq,
                              N_FRAMES - 1)

    if not _fusion_launches_ok(launches, checker.dispatches):
        raise AssertionError(f"kernel launches {launches} != TSDF dispatches {checker.dispatches}")
    if set(checker.checked) != {"fast", "rows"}:
        raise AssertionError(f"main-path kernel checks incomplete: {checker.checked}")
    if eng.reint_frames < 1:
        raise AssertionError("no re-integration frame ran")
    if any(inv.values()) or fails:
        raise AssertionError(f"table invariants {inv}, alloc failures {fails}")
    if len(verts) == 0:
        raise AssertionError("empty mesh")
    last = eng.last_render["depth"]
    if tuple(last.shape) != (eng.intr_int.height, eng.intr_int.width) or not torch.isfinite(last).any():
        raise AssertionError(f"last_render depth {tuple(last.shape)} holds no surface")
    if not med_err < 2 * eng.tsdf_params.voxel_size:
        raise AssertionError(f"render median |depth - GT| {med_err} m >= 2 voxels")
    return {
        "frames": N_FRAMES,
        "launches": launches,
        "tsdf_dispatches": checker.dispatches,
        "reint_frames": eng.reint_frames,
        "reint_ops_total": eng.reint_ops_total,
        "live_blocks": int((eng.table.slot_keys[:-1] != 2**31 - 1).sum()),
        "alloc_failures": fails,
        "mesh_triangles": int(len(verts)),
        "mesh_ms": mesh_ms,
        "render_median_abs_err_m": med_err,
        "render_hit_pixels": hit,
        "main_path_checks": checker.checked,
        "stage_ms_median": {k: (statistics.median(v) if v else None) for k, v in stages.items()},
        "stage_counts": {k: len(v) for k, v in stages.items()},
        "loop_s": loop_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


class _OpCounter(TorchDispatchMode):
    """Counts the torch ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class _StageCounts:
    """Stands in for the engine's ``TimingLog``: every stage of
    ``_frame_step`` runs under its own profiler trace and op counter, and
    the log keeps per stage the CUDA kernels and copies the card ran, their
    device time and the torch ops the host dispatched. Starting a trace
    costs tens of ms, so this is for a frame or two, not for timing."""

    enabled = True

    def __init__(self):
        self.totals = {}

    def stage(self, attr):
        return _CountedStage(self.totals.setdefault(
            attr, {"device_ops": 0, "device_ms": 0.0, "dispatched_ops": 0}))

    def span(self, name, frame=None):
        return contextlib.nullcontext()


class _CountedStage:
    def __init__(self, total):
        self.total = total

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.ops = _OpCounter()
        self.prof.__enter__()
        self.ops.__enter__()

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        self.ops.__exit__(*exc)
        _sync()
        self.prof.__exit__(*exc)
        evs = [e for e in self.prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        self.total["device_ops"] += sum(e.count for e in evs)
        self.total["device_ms"] += sum(e.self_device_time_total for e in evs) / 1e3
        self.total["dispatched_ops"] += self.ops.n
        if "kernels" in self.total:     # by kernel name: [device ms, launches]
            for e in evs:
                ms_n = self.total["kernels"].setdefault(e.key[:80], [0.0, 0])
                ms_n[0] += e.self_device_time_total / 1e3
                ms_n[1] += e.count
        return False


class _PlainKabsch:
    """Runs the frontend's greedy filter as its plain version
    (``kabsch_filter_ref``, torch ops and host reads) while active: the
    comparison run of ``phase_frontend``. The package has no such switch;
    this patches the name ``match_and_filter`` calls."""

    def __enter__(self):
        from bundlefusion_tpu_torch.ops import filters
        from bundlefusion_tpu_torch.pipeline import frontend

        self.frontend, self.inner = frontend, frontend.kabsch_filter
        frontend.kabsch_filter = filters.kabsch_filter_ref
        return self

    def __exit__(self, *exc):
        self.frontend.kabsch_filter = self.inner
        return False


class _FrontendProbe:
    """Wraps the matcher and ``match_and_filter`` as the engine calls them
    and keeps, per frame and on the device, the number of raw matches per
    active pair, of filtered matches per valid pair and of valid pairs, and
    the greedy filter's count of host reads.
    Nothing is read back until :meth:`summary`."""

    def __init__(self):
        from bundlefusion_tpu_torch.pipeline import frontend, online

        self.modules = (frontend, online)
        self.inner_match = frontend.match_current_against_previous
        self.inner_mf = online.match_and_filter
        self.raw, self.filtered, self.pairs, self.reads = [], [], [], []

    def __enter__(self):
        frontend, online = self.modules

        def match(*args, **kw):
            m = self.inner_match(*args, **kw)
            self.raw.append(m.valid.sum(-1).float().mean())
            return m

        def mf(*args, **kw):
            out = self.inner_mf(*args, **kw)
            n_pairs = out["pair_valid"].sum()
            self.pairs.append(n_pairs)
            self.reads.append(out["kabsch_host_reads"])
            self.filtered.append(out["num_inliers"].sum() / torch.clamp(n_pairs, min=1))
            return out

        frontend.match_current_against_previous = match
        online.match_and_filter = mf
        return self

    def __exit__(self, *exc):
        frontend, online = self.modules
        frontend.match_current_against_previous = self.inner_match
        online.match_and_filter = self.inner_mf
        return False

    def summary(self):
        pairs = torch.stack(self.pairs).cpu().numpy()
        return {
            "raw_matches_per_pair_mean": float(torch.stack(self.raw).mean()),
            "filtered_matches_per_valid_pair_mean": float(torch.stack(self.filtered).mean()),
            "valid_pairs_per_frame_mean": float(pairs.mean()),
            "valid_pairs_per_frame_min": int(pairs.min()),
            "kabsch_host_reads_per_frame_mean": statistics.fmean(self.reads),
            "kabsch_host_reads_per_frame_max": max(self.reads),
        }


def _drive_frontend_frame(eng, seq, f, stage, count_waits=False):
    """Frame ``f`` of the whole per-frame path, in the order ``process_frame``
    has it, each stage run through ``stage(name, fn)``: the frame step, the
    TSDF dispatch and the render, which take the step's pose and validity on
    the card (the frame graph's outputs themselves when it replays), then
    this phase's own bookkeeping, which reads the pose back (the engine
    records a window's poses at its boundary). Frame k * (S-1) is slot S-1
    of window k-1; after it the window rolls over and the frame's chained
    pose becomes the new window's base (where the solver's pose will go).
    Returns (cur_slot, valid, the host waits of the path when
    ``count_waits``, else None)."""
    sub_len = eng.S - 1
    slot = f % sub_len
    boundary = f > 0 and slot == 0
    cur_slot = sub_len if boundary else slot
    store_slot = eng._store_slot(f)
    eng.frame_idx = f

    def path():
        T_dev, valid_dev = stage("frame_step", lambda: eng._run_frame_step(
            seq["depth"][f], seq["color"][f], cur_slot, store_slot))
        T_in, v_in = ((eng._static["T_world"], eng._static["valid"]) if eng._graphs_on()
                      else (T_dev, valid_dev))
        stage("tsdf", lambda: eng._tsdf_dispatch(store_slot, T_in, v_in))
        stage("render", lambda: eng._render_frame(f, T_in))
        return T_dev, valid_dev

    (T_dev, valid_dev), waits = _sync_warnings(path) if count_waits else (path(), None)
    valid = bool(valid_dev)
    eng._record_frame(f, T_dev.cpu().numpy(), valid)
    if boundary:
        eng._rollover_local()
        eng.submap_base.copy_(T_dev)
    return cur_slot, valid, waits


def _stage_ms(log, coarse):
    """Median ms per stage: the engine's ``TimingLog`` and the coarse
    stages timed here."""
    out = {k: v * 1e3 for k, v in log.medians().items()}
    out.update({k: statistics.median(v) * 1e3 for k, v in coarse.items()})
    return out


def _sync_warnings(fn):
    """(fn's result, how many operations in it made the host wait for the
    card), from ``set_sync_debug_mode("warn")``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_frontend(dev, seq, gt, app, bundling=None, sift_cfg=None, n_frames=N_FRAMES):
    """The whole per-frame path with the engine's own poses; see the module
    docstring. ``bundling`` / ``sift_cfg`` default to the engine's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.config import BundlingConfig
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.tsdf.table import check_invariants
    from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse

    bundling = bundling or BundlingConfig()

    def engine(mode):
        """An engine whose ``_frame_step`` runs as ``mode`` says: replayed
        from its graphs (captured here, before the first frame), eagerly,
        or eagerly with the greedy filter's plain version (which reads the
        card and cannot be captured)."""
        eng = BundleFusion(seq["intrinsics"], app, bundling, sift_cfg=sift_cfg,
                           max_keyframes=n_frames // bundling.submap_size + 2, device=dev)
        # the graph run replays the frame step and the fusion programs; the
        # others run both eagerly
        eng._eager_frame_step = eng._eager_fusion = mode != "graph"
        if mode == "graph":
            eng._build_programs()
            _sync()
        return eng

    def drive(eng, stage_syncs):
        """All frames; per-frame wall ms (one wait at the frame's end), the
        coarse stages' seconds and the host waits of each frame's step. With
        ``stage_syncs`` every stage, the engine's own included, is closed by
        a wait for the card."""
        eng.timing.sync = _sync if stage_syncs else None
        coarse, path_syncs = {}, []

        def stage(name, fn):
            if stage_syncs:
                _sync()
            t0 = time.perf_counter()
            r = fn()
            if stage_syncs:
                _sync()
            coarse.setdefault(name, []).append(time.perf_counter() - t0)
            return r

        frame_ms, valid, keys = [], [], []
        for f in range(n_frames):
            _sync()
            t0 = time.perf_counter()
            cur_slot, v, waits = _drive_frontend_frame(eng, seq, f, stage,
                                                       count_waits=not stage_syncs)
            _sync()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            valid.append(v)
            path_syncs.append(waits)
            # after a rollover the frame sits in slot 0 of the new window
            keys.append(eng.local.keys.valid[0 if cur_slot == eng.S - 1 else cur_slot].sum())
        return frame_ms, valid, coarse, torch.stack(keys).cpu().numpy(), path_syncs

    def counted_run(mode):
        """Run A: one wait per frame; the kernel launches, frame times,
        the step's host waits and flags."""
        eng = engine(mode)
        for name in kernels.launch_counts:
            kernels.launch_counts[name] = 0
        torch.cuda.reset_peak_memory_stats()
        with _PlainKabsch() if mode == "plain" else contextlib.nullcontext():
            frame_ms, valid, coarse, keys, path_syncs = drive(eng, stage_syncs=False)
        return eng, frame_ms, valid, coarse, keys, dict(kernels.launch_counts), path_syncs

    def summary(mode, frame_ms, coarse, launches, path_syncs):
        return {"mode": mode,
                "frame_ms_median": statistics.median(frame_ms),
                "frame_ms_max": max(frame_ms[1:]),
                "frame_step_host_ms_median": statistics.median(coarse["frame_step"]) * 1e3,
                "tsdf_host_ms_median": statistics.median(coarse["tsdf"]) * 1e3,
                "render_host_ms_median": statistics.median(coarse["render"]) * 1e3,
                # host waits of the whole per-frame path (step, TSDF, render)
                "syncs_per_frame_mean": statistics.fmean(path_syncs),
                "syncs_per_frame_max": max(path_syncs),
                "launches": launches,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    def digest(eng):
        """Checksums of every table tensor and of the last render: what
        the graph and the eager runs must give bit for bit."""
        from bundlefusion_tpu_torch.pipeline.online import _checksum

        out = {f"table.{f.name}": _checksum(getattr(eng.table, f.name)).tolist()
               for f in dataclasses.fields(eng.table)}
        out.update({f"render.{k}": _checksum(v).tolist() for k, v in eng.last_render.items()})
        return out

    def staged_run(plain):
        """Run B (eager): a wait around every stage, the probe on: stage
        times, flags, raw / filtered matches and the filter's host reads."""
        eng = engine("plain" if plain else "eager")
        with _PlainKabsch() if plain else contextlib.nullcontext(), _FrontendProbe() as probe:
            frame_ms, valid, coarse, _, _ = drive(eng, stage_syncs=True)
        out = {"frame_ms_median_with_stage_syncs": statistics.median(frame_ms),
               "stage_ms_median": _stage_ms(eng.timing, coarse), **probe.summary()}
        out["ate_rmse_m"], _ = evaluate_ate_rmse(np.stack(eng.sift_world), gt[:n_frames])
        del eng
        torch.cuda.empty_cache()
        return out, valid

    def profiled_run(mode):
        """Run C: the step alone under the profiler (launches, device time,
        busy share; for the graphs also CUDA events around each replay),
        then, run eagerly, two frames with a trace and an op counter per
        stage."""
        eng = engine(mode)
        first = min(n_frames - FRONTEND_PROFILE_FRAMES - 2, bundling.submap_size + 1)
        for f in range(first):
            _drive_frontend_frame(eng, seq, f, lambda _name, fn: fn())
        _sync()
        sub_len = eng.S - 1
        n_prof = FRONTEND_PROFILE_FRAMES
        frames = range(first, first + n_prof)
        handles = {f: eng.upload_frame(seq["depth"][f], seq["color"][f]) for f in frames}
        _sync()
        event_ms = []
        with _PlainKabsch() if mode == "plain" else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for f in frames:
                    eng._run_frame_step(*handles[f], f % sub_len, eng._store_slot(f))
                _sync()
                wall_ms = (time.perf_counter() - t0) * 1e3
            evs = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            device_ms = sum(e.self_device_time_total for e in evs) / 1e3
            if not device_ms > 0 and mode != "graph":
                raise AssertionError("the profiler's trace holds no device time")
            evs.sort(key=lambda e: -e.self_device_time_total)
            if mode == "graph":
                for f in frames:
                    event_ms.append(_event_ms(lambda f=f: eng._run_frame_step(
                        *handles[f], f % sub_len, eng._store_slot(f))))
            # two more frames, eagerly, each stage under its own trace and
            # op counter
            eng._eager_frame_step = True
            eng.timing = counts = _StageCounts()
            n_counted = 2
            for f in range(first + n_prof, first + n_prof + n_counted):
                eng._frame_step(seq["depth"][f], seq["color"][f], f % sub_len,
                                eng._store_slot(f))
        per_stage = {k: {name: v / n_counted for name, v in tot.items()}
                     for k, tot in sorted(counts.totals.items())}
        del eng
        torch.cuda.empty_cache()
        out = {
            "mode": mode,
            "frames": n_prof,
            "first_frame": first,
            "cuda_kernels_per_frame": sum(e.count for e in evs) / n_prof,
            "dispatched_ops_per_frame": sum(v["dispatched_ops"] for v in per_stage.values()),
            "wall_ms_per_frame": wall_ms / n_prof,
            "device_ms_per_frame": device_ms / n_prof if device_ms > 0 else None,
            "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
            "top_device_ms_per_frame": [[e.key[:80], e.self_device_time_total / 1e3 / n_prof,
                                         e.count / n_prof] for e in evs[:10]],
            "per_stage_eager": per_stage,
        }
        if event_ms:
            # CUDA events around the replays (inputs' copies included): the
            # step's span on the card, gaps between its nodes included
            out["replay_event_ms_median"] = statistics.median(event_ms)
        return out

    # ---- run A with the graphs: the checks ----
    eng, frame_ms, valid, coarse_a, keys, launches, syncs_a = counted_run("graph")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_ms = _stage_ms(eng.timing, coarse_a)
    in_turns = [summary("graph", frame_ms, coarse_a, launches, syncs_a)]

    ate, n_ate = evaluate_ate_rmse(np.stack(eng.sift_world), gt[:n_frames])
    inv = check_invariants(eng.table)
    fails = int(eng.table.num_alloc_failures)
    med_err, _ = _depth_err(eng.last_render["depth"], seq, n_frames - 1)
    live_corrs = int(eng.local.corrs.valid_mask().sum())
    live_blocks = int((eng.table.slot_keys[:-1] != EMPTY_KEY).sum())

    if not all(valid):
        raise AssertionError(f"frames lost: {[f for f, v in enumerate(valid) if not v]}")
    if any(n == 0 for n in launches.values()) or set(launches) != set(kernels.SOURCES):
        raise AssertionError(f"a kernel was never launched on the frontend path: {launches}")
    if not (n_ate == n_frames and ate < ATE_MAX_M):
        raise AssertionError(f"chained ATE RMSE {ate} m over {n_ate} frames (limit {ATE_MAX_M})")
    if any(inv.values()) or fails:
        raise AssertionError(f"table invariants {inv}, alloc failures {fails}")
    if not med_err < 2 * eng.tsdf_params.voxel_size:
        raise AssertionError(f"render median |depth - GT| {med_err} m >= 2 voxels")
    if any(syncs_a):
        raise AssertionError(f"a replayed per-frame path made the host wait: {syncs_a}")
    final_graph = np.stack(eng.sift_world)
    digest_graph = digest(eng)
    recaptures = eng.fusion_recaptures
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # ---- in turns: eager, plain filter, eager, graph (run A each) ----
    runs = {}
    for mode in ("eager", "plain", "eager", "graph"):
        eng, ms, v, coarse, _, la, syncs = counted_run(mode)
        if v != valid:
            raise AssertionError(f"validity flags differ between the graph run and a {mode} "
                                 f"run: {valid} {v}")
        in_turns.append(summary(mode, ms, coarse, la, syncs))
        runs.setdefault(mode, (eng.timing, coarse, np.stack(eng.sift_world), la, syncs,
                               digest(eng)))
        del eng
        gc.collect()   # the engine holds reference cycles: free its memory before the next
        torch.cuda.empty_cache()
    eager_log, coarse_e, final_eager, launches_e, syncs_e, digest_eager = runs["eager"]
    host_ms_p = _stage_ms(runs["plain"][0], runs["plain"][1])
    ate_p, _ = evaluate_ate_rmse(runs["plain"][2], gt[:n_frames])
    launches_p = runs["plain"][3]
    if launches_e != launches or any(syncs_e):
        raise AssertionError(f"eager run: launches {launches_e} against the graphs' "
                             f"{launches}, host waits {syncs_e}")
    graph_equals_eager = bool(np.array_equal(final_graph, final_eager))
    if not graph_equals_eager:
        raise AssertionError("the chained poses of the graph and the eager run differ: "
                             f"{np.abs(final_graph - final_eager).max()}")
    differ = sorted(k for k in digest_graph if digest_graph[k] != digest_eager[k])
    if differ:
        raise AssertionError(f"the graph and the eager run's tables / last renders differ: "
                             f"{differ}")
    if any(launches_p[k] != launches[k] for k in TSDF_KERNELS) or launches_p["kabsch_filter"]:
        raise AssertionError(f"plain run launches {launches_p} against {launches}")
    staged_p, valid_bp = staged_run(plain=True)
    staged, valid_b = staged_run(plain=False)
    if not valid_b == valid_bp == valid:
        raise AssertionError(f"validity flags differ between the staged runs (plain B, kernel "
                             f"B) and run A: {valid_bp} {valid_b} {valid}")
    if staged["valid_pairs_per_frame_min"] < 1:
        raise AssertionError("a frame after the first had no valid pair")
    if staged["kabsch_host_reads_per_frame_max"] != 0:
        raise AssertionError(f"the kernel's filter read the card: {staged}")
    stage_ms = staged.pop("stage_ms_median")
    frame_step_profile = profiled_run("graph")
    frame_step_profile_eager = profiled_run("eager")
    frame_step_profile_plain = profiled_run("plain")

    return {
        "frames": n_frames,
        "all_valid": True,
        "ate_rmse_m": ate,
        "ate_rmse_m_second_run": staged.pop("ate_rmse_m"),
        "render_median_abs_err_m": med_err,
        "alloc_failures": fails,
        "launches": launches,
        "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_max": max(frame_ms[1:]),
        "frame_ms_median_with_stage_syncs": staged.pop("frame_ms_median_with_stage_syncs"),
        "stage_ms_median": stage_ms,
        "stage_host_ms_median": host_ms,
        "stage_host_ms_median_eager": _stage_ms(eager_log, coarse_e),
        "keys_per_frame_mean": float(keys.mean()),
        "keys_per_frame_min": int(keys.min()),
        **staged,
        "live_corrs_last_window": live_corrs,
        "live_blocks": live_blocks,
        "peak_mem_gb": peak_gb,
        "frame_step_profile": frame_step_profile,
        "frame_step_profile_eager": frame_step_profile_eager,
        # runs A in turns (graph, eager, plain, eager, graph): the same 40
        # validity flags in every run, the graph's and the eager run's chained
        # poses bit for bit, their launches equal
        "graph_vs_eager": {"valid_equal": True, "poses_bitwise_equal": graph_equals_eager,
                           "table_and_render_bitwise_equal": True,
                           "fusion_recaptures": recaptures, "in_turns": in_turns},
        # the greedy filter's plain version (eager)
        "plain_filter": {
            "valid_equal": True,
            "ate_rmse_m": ate_p,
            "launches": launches_p,
            "stage_host_ms_median": host_ms_p,
            "frame_step_profile": frame_step_profile_plain,
            **staged_p,
        },
    }


def phase_engine(dev, seq, gt, app, bundling=None, sift_cfg=None, n_frames=N_FRAMES,
                 max_keyframes=None):
    """The whole engine through its public entry points; see the module
    docstring. ``bundling`` / ``sift_cfg`` default to the engine's, and
    ``max_keyframes`` to the configuration's 1200."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.config import BundlingConfig
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.solver.gn_pcg import lu_zero_steps
    from bundlefusion_tpu_torch.tsdf.table import check_invariants
    from bundlefusion_tpu_torch.utils import host_reads
    from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse

    bundling = bundling or BundlingConfig()
    sub_len = bundling.submap_size

    def run(stage_syncs=False, check_apply=False, wrap_boundary=None):
        """warmup, every frame through upload_frame + process_frame (frame
        i + 1 uploads while frame i computes), finish. Returns the engine,
        per-frame wall ms (one wait at the frame's end), finish's ms and the
        warm-up's seconds."""
        eng = BundleFusion(seq["intrinsics"], app, bundling, sift_cfg=sift_cfg,
                           max_keyframes=max_keyframes, device=dev)
        warm_s = eng.warmup()
        eng.timing.sync = _sync if stage_syncs else None
        checker = None
        if check_apply:
            checker = _check_apply(eng)
        if wrap_boundary is not None:
            eng._submap_step = wrap_boundary(eng._submap_step)
        frame_ms = []
        handle = eng.upload_frame(seq["depth"][0], seq["color"][0])
        for f in range(n_frames):
            _sync()
            t0 = time.perf_counter()
            nxt = (eng.upload_frame(seq["depth"][f + 1], seq["color"][f + 1])
                   if f + 1 < n_frames else None)
            eng.process_frame(handle)
            _sync()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            handle = nxt
        t0 = time.perf_counter()
        eng.finish()
        _sync()
        return eng, frame_ms, (time.perf_counter() - t0) * 1e3, warm_s, checker

    # ---- run A: the entry points as a user calls them; the checks ----
    marks = [time.perf_counter()]
    lu_zero_steps(dev, reset=True)
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    torch.cuda.reset_peak_memory_stats()
    reads0 = host_reads["count"]
    t0 = time.perf_counter()
    eng, frame_ms, finish_ms, warm_s, checker = run(check_apply=True)
    run_s = time.perf_counter() - t0 - warm_s
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reads_run = host_reads["count"] - reads0
    zero_steps = lu_zero_steps(dev)

    traj = eng.trajectory()
    valid = list(eng.frame_valid)
    ate, n_ate = evaluate_ate_rmse(traj, gt[:n_frames])
    ate_chained, _ = evaluate_ate_rmse(np.stack(eng.sift_world), gt[:n_frames])
    inv = check_invariants(eng.table)
    fails = int(eng.table.num_alloc_failures)
    verts, _ = eng.extract_mesh()
    last_pose = traj[n_frames - 1]
    med_err, hit = _depth_err(eng._render(eng.table, last_pose)["depth"], seq, n_frames - 1)
    n_submaps = eng.num_keyframes
    kf_valid = int(eng.keyframe_valid[:n_submaps].sum())
    want_submaps = -(-(n_frames - 1) // sub_len)

    if len(valid) != n_frames or not all(valid):
        raise AssertionError(f"frames lost: {[f for f, v in enumerate(valid) if not v]}")
    if not (n_ate == n_frames and ate < ATE_MAX_M):
        raise AssertionError(f"ATE RMSE {ate} m over {n_ate} frames (limit {ATE_MAX_M})")
    if n_submaps != want_submaps or kf_valid < want_submaps - 1:
        raise AssertionError(f"{n_submaps} submaps dispatched ({want_submaps} expected), "
                             f"{kf_valid} keyframes valid")
    if eng.reint_frames < 1 or "rows" not in checker.checked:
        raise AssertionError(f"no 11-op dispatch came out of the engine's own pose updates: "
                             f"reint_frames {eng.reint_frames}, checks {checker.checked}")
    if any(n == 0 for n in launches.values()) or set(launches) != set(kernels.SOURCES):
        raise AssertionError(f"a TSDF kernel was never launched by process_frame: {launches}")
    if any(inv.values()) or fails:
        raise AssertionError(f"table invariants {inv}, alloc failures {fails}")
    if not med_err < 2 * eng.tsdf_params.voxel_size:
        raise AssertionError(f"render median |depth - GT| {med_err} m >= 2 voxels")
    if not len(verts) > 10_000:
        raise AssertionError(f"mesh of {len(verts)} triangles")
    boundary_frames = [f for f in range(1, n_frames) if f % sub_len == 0]
    plain_frames = [f for f in range(1, n_frames) if f % sub_len]
    out = {
        "frames": n_frames,
        "keyframe_capacity": eng.G,
        "frame_archive_capacity": eng.frame_cap,
        "global_corr_capacity": eng.glob.corrs.capacity,
        "all_valid": True,
        "submaps": n_submaps,
        "keyframes_valid": kf_valid,
        "ate_rmse_m": ate,
        "ate_rmse_m_chained": ate_chained,
        "render_median_abs_err_m": med_err,
        "render_hit_pixels": hit,
        "mesh_triangles": int(len(verts)),
        "alloc_failures": fails,
        "launches": launches,
        "main_path_checks": checker.checked,
        "reint_frames": eng.reint_frames,
        "reint_ops_total": eng.reint_ops_total,
        "pairs_dropped_total": eng.pairs_dropped_total,
        "lost_count": eng.lost_count,
        "retry_list": list(eng.retry_list),
        "lu_zero_steps": zero_steps,
        "warmup_s": warm_s,
        "frames_per_s": n_frames / (sum(frame_ms) / 1e3),
        "run_s_with_finish": run_s,
        "frame_ms_median": statistics.median(frame_ms[f] for f in plain_frames),
        "frame_ms_boundary": [frame_ms[f] for f in boundary_frames],
        "finish_ms": finish_ms,
        "host_reads_run": reads_run,
        "host_reads_per_boundary": [s["host_reads"] for s in eng.boundary_stats],
        "prune_rounds_per_boundary": [s["prune_rounds"] for s in eng.boundary_stats],
        "global_live_corrs": int(eng.glob.corrs.valid_mask().sum()),
        "live_blocks": int((eng.table.slot_keys[:-1] != EMPTY_KEY).sum()),
        "peak_mem_gb": peak_gb,
    }
    traj_a = traj.copy()
    del eng, checker
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())

    # ---- run B: a wait around every stage (the boundary's split); the
    # flags must repeat ----
    eng, frame_ms_b, finish_ms_b, _, _ = run(stage_syncs=True)
    if list(eng.frame_valid) != valid:
        raise AssertionError(f"validity flags differ between two runs: {valid} vs "
                             f"{eng.frame_valid}")
    traj_b = eng.trajectory()
    out["trajectory_repeats_bitwise"] = bool(np.array_equal(traj_a, traj_b, equal_nan=True))
    out["trajectory_max_abs_diff_second_run"] = float(np.nanmax(np.abs(traj_a - traj_b)))
    totals, med = eng.timing.totals(), eng.timing.medians()
    # each stage's mean over the boundaries that run it: "step" is the whole
    # boundary inside process_frame (3 of them), the global stages skip g = 0
    out["submap_step_ms_mean"] = {
        k[len("time_submap_"):]: v * 1e3 for k, v in eng.timing.averages().items()
        if k.startswith("time_submap_")}
    out["finish_ms_with_stage_syncs"] = finish_ms_b
    out["finish_dense_solve_ms"] = totals["time_finish_dense_solve"] * 1e3
    out["frame_ms_median_with_stage_syncs"] = statistics.median(
        frame_ms_b[f] for f in plain_frames)
    out["frame_step_ms_median_with_stage_syncs"] = med["time_frame_step"] * 1e3
    del eng
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())

    # ---- run C: under a trace of the card alone: busy share over the run ----
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng = run()[0]
        wall_ms = (time.perf_counter() - t0) * 1e3     # the warm-up included, as in the trace
    if list(eng.frame_valid) != valid:
        raise AssertionError("validity flags differ under the profiler")
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    if not device_ms > 0:
        raise AssertionError("the profiler's trace holds no device time")
    out["profile"] = {"wall_ms": wall_ms, "device_ms": device_ms,
                      "device_busy_share": device_ms / wall_ms}
    del eng, prof
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())

    # ---- run D: every boundary under a trace and an op counter of its own
    # (a trace of the whole run with the host's ops in it takes minutes to
    # read): launches, device ms and dispatched ops per boundary, and the
    # kernels the boundaries spend most on ----
    per_boundary = []

    def wrap(inner):
        def step(g, last_world):
            per_boundary.append({"device_ops": 0, "device_ms": 0.0, "dispatched_ops": 0,
                                 "kernels": {}})
            with _CountedStage(per_boundary[-1]):
                return inner(g, last_world)
        return step

    eng = run(wrap_boundary=wrap)[0]
    if list(eng.frame_valid) != valid:
        raise AssertionError("validity flags differ with the boundaries traced")
    by_name = {}
    for b in per_boundary:
        for name, (ms, n) in b.pop("kernels").items():
            ms_n = by_name.setdefault(name, [0.0, 0])
            ms_n[0] += ms
            ms_n[1] += n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out["boundary_profile"] = {
        "per_boundary": per_boundary,
        "top_device_ms": [[name, ms, n] for name, (ms, n) in top],
    }
    del eng
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    out["runs_s"] = dict(zip(("checked", "stage_syncs", "card_traced", "boundaries_traced"),
                             (b - a for a, b in zip(marks, marks[1:]))))
    return out


def phase_solver_width(dev, n_frames=1200, reach=3, corrs_per_pair=16):
    """The sparse solver at the keyframe capacity: the ring graph of
    ``io.synthetic.ring_pose_graph`` perturbed by 0.01, solved with the
    direct and with the PCG linear step; ms by CUDA events."""
    from bundlefusion_tpu_torch.io.synthetic import ring_pose_graph
    from bundlefusion_tpu_torch.solver import gn_pcg
    from bundlefusion_tpu_torch.solver.residuals import corr_store_from_numpy
    from bundlefusion_tpu_torch.utils import host_reads

    gt, arrays = ring_pose_graph(n_frames, corrs_per_pair, reach)
    rng = np.random.default_rng(0)
    init = gt + rng.normal(size=gt.shape).astype(np.float32) * 0.01
    init[0] = gt[0]
    store = corr_store_from_numpy(arrays, dev)
    poses0 = torch.as_tensor(init, device=dev)
    valid = torch.ones(n_frames, dtype=torch.bool, device=dev)
    out = {"frames": n_frames, "corrs": int(arrays["count"]),
           "pairs": int(arrays["count"]) // corrs_per_pair}
    for linear in ("dense", "pcg"):
        params = gn_pcg.SolverParams(num_gn=3, num_pcg=60, max_pairs=4096, linear=linear)
        gn_pcg.solve_sparse(poses0, valid, store, params)        # first-call set-up
        _sync()
        reads0 = host_reads["count"]
        res = {}
        ms = _event_ms(lambda: res.update(zip(("poses", "stats"),
                                              gn_pcg.solve_sparse(poses0, valid, store, params))))
        st = res["stats"]
        c0, c1 = float(st.initial_cost), float(st.final_cost)
        err = float((res["poses"] - torch.as_tensor(gt, device=dev)).abs().max())
        if int(st.num_pairs_dropped) or not c1 < 1e-3 * c0:
            raise AssertionError(f"solve_sparse({linear}) at N={n_frames}: cost {c0} -> {c1}, "
                                 f"{int(st.num_pairs_dropped)} pairs dropped")
        out[linear] = {"ms": ms, "initial_cost": c0, "final_cost": c1, "max_abs_pose_err": err,
                       "host_reads": host_reads["count"] - reads0}
    # the direct step's parts, on the first iteration's system
    params = gn_pcg.SolverParams(num_gn=3, max_pairs=4096, linear="dense")
    prob = gn_pcg.presort_corrs(store, n_frames, params)
    free_f = (valid & (torch.arange(n_frames, device=dev) != 0)).to(torch.float32)[:, None]
    H, b = gn_pcg.build_sparse_pair_system(poses0, prob.sc, 1.0, n_live=prob.bound)
    Ad, rhs, _ = gn_pcg._assemble_reduced(H, b, prob, free_f, n_frames)
    _sync()
    times = {"presort": [], "build": [], "assemble": [], "lu": []}
    for _ in range(REPS):
        times["presort"].append(_event_ms(lambda: gn_pcg.presort_corrs(store, n_frames, params)))
        times["build"].append(_event_ms(lambda: gn_pcg.build_sparse_pair_system(
            poses0, prob.sc, 1.0, n_live=prob.bound)))
        times["assemble"].append(_event_ms(lambda: gn_pcg._assemble_reduced(
            H, b, prob, free_f, n_frames)))
        times["lu"].append(_event_ms(lambda: torch.linalg.solve_ex(Ad, rhs[:, None])))
    out["dense_parts_ms"] = {k: statistics.median(v) for k, v in times.items()}
    out["system_size"] = int(Ad.shape[0])
    # 2/3 n^3 operations of the factorisation against the float32 peak
    out["lu_bound_ms"] = (2 / 3) * Ad.shape[0] ** 3 / FP32_FLOP_PER_S * 1e3
    del Ad, H, b, prob, store
    torch.cuda.empty_cache()
    return out


def _wrap_attr(obj, name, make):
    """Replace ``obj.name`` by ``make(original)``; returns a restorer."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    return lambda: setattr(obj, name, orig)


def _payload_by_key(table) -> dict:
    """{packed key: (sdf row, weight row)} as host copies."""
    keys, slots = table.keys.cpu().numpy(), table.slots.cpu().numpy()
    occ = keys != EMPTY_KEY
    sdf, w = table.sdf.cpu().numpy(), table.weight.cpu().numpy()
    return {int(k): (sdf[s], w[s]) for k, s in zip(keys[occ], slots[occ])}


def _recorded_engine(dev, seq, app, bundling, sift_cfg, n_frames, **streaming):
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    eng = BundleFusion(seq["intrinsics"], dataclasses.replace(app, **streaming), bundling,
                       sift_cfg=sift_cfg, max_keyframes=n_frames // bundling.submap_size + 2,
                       device=dev)
    eng.warmup()
    return eng


def _feed(eng, seq, frames):
    for f in frames:
        eng.process_frame(seq["depth"][f], seq["color"][f])


def phase_recorded(dev, seq, gt, app, bundling=None, sift_cfg=None, n_frames=N_FRAMES,
                   page_frames=PAGE_FRAMES, cli_args=()):
    """The recorded-scan path; see the module docstring. ``bundling`` /
    ``sift_cfg`` default to the engine's; ``cli_args`` are added to the
    command line (none on the card)."""
    import shutil
    import tempfile

    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.config import BundlingConfig

    bundling = bundling or BundlingConfig()
    intr = seq["intrinsics"]
    out = {"frames": n_frames, "width": intr.width, "height": intr.height}
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    tmp = tempfile.mkdtemp(prefix="bf_recorded_")
    try:
        _phase_recorded_body(dev, seq, gt, app, bundling, sift_cfg, n_frames, page_frames,
                             cli_args, tmp, out)
    except Exception:
        print(f"chip_smoke: phase_recorded so far: {json.dumps(out, default=str)[:20000]}",
              file=sys.stderr)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = dict(kernels.launch_counts)
    if any(n == 0 for n in out["launches"].values()) or set(out["launches"]) != set(
            kernels.SOURCES):
        raise AssertionError(f"a TSDF kernel was not launched in this phase: {out['launches']}")
    return out


def _phase_recorded_body(dev, seq, gt, app, bundling, sift_cfg, n_frames, page_frames,
                         cli_args, tmp, out):
    """The checks of :func:`phase_recorded`, filling ``out``; files go to
    ``tmp``."""
    import contextlib
    import io
    import os
    import zlib

    from bundlefusion_tpu_torch import __main__ as cli
    from bundlefusion_tpu_torch.io import native
    from bundlefusion_tpu_torch.io.sens import SensData, SensFrame, load_sens, save_sens
    from bundlefusion_tpu_torch.pipeline import online
    from bundlefusion_tpu_torch.tsdf import streaming
    from bundlefusion_tpu_torch.tsdf.table import check_invariants, garbage_collect

    intr = seq["intrinsics"]
    H, W = intr.height, intr.width
    # ---- 1. the recording: raw colour, zlib depth, true poses ----
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = intr.fx, intr.fy, intr.cx, intr.cy
    eye = np.eye(4, dtype=np.float32)
    data = SensData(
        version=4, sensor_name="synthetic", intrinsic_color=K, extrinsic_color=eye,
        intrinsic_depth=K, extrinsic_depth=eye, compression_color=0, compression_depth=1,
        color_width=W, color_height=H, depth_width=W, depth_height=H, depth_shift=1000.0,
        frames=[SensFrame(gt[f].astype(np.float32), f, f,
                          np.ascontiguousarray(seq["color"][f]).tobytes(),
                          zlib.compress(np.ascontiguousarray(seq["depth"][f]).tobytes()))
                for f in range(n_frames)])
    sens_path = os.path.join(tmp, "recorded.sens")
    save_sens(sens_path, data)
    out["sens_bytes"] = os.path.getsize(sens_path)

    # ---- 2. depth decode: the native codec against Python zlib ----
    bufs = [fr.depth_bytes for fr in data.frames]
    out["native_available"] = native.native_available()
    out["native_library"] = (os.path.relpath(native.loaded_from, os.getcwd())
                             if native.loaded_from else None)
    t0 = time.perf_counter()
    dec_native = native.decode_depth_batch(bufs, H, W, data.depth_shift)
    out["decode_native_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n_frames
    t0 = time.perf_counter()
    dec_python = native.decode_depth_batch_python(bufs, H, W, data.depth_shift)
    out["decode_python_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n_frames
    if not out["native_available"]:
        raise AssertionError("the native depth codec neither loads nor builds")
    if not np.array_equal(dec_native.view(np.uint32), dec_python.view(np.uint32)):
        raise AssertionError("native and Python zlib depth decodes differ")
    wire = seq["depth"][:n_frames]
    if not np.array_equal(np.isnan(dec_native), wire == 0) or not np.array_equal(
            np.where(wire > 0, np.rint(dec_native * 1000.0), 0).astype(np.uint16), wire):
        raise AssertionError("decoded depth does not round-trip to the wire frames")
    out["decode_bitwise_equal"] = True

    # ---- 3. the CLI on the recording, in this process ----
    kept = []

    def keep(cls):
        class Kept(cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                kept.append(self)
        return Kept

    restore = _wrap_attr(online, "BundleFusion", keep)
    log = io.StringIO()
    cli_out = os.path.join(tmp, "cli")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main([sens_path, "--out", cli_out, *cli_args])
        _sync()
        out["cli_s"] = time.perf_counter() - t0
    finally:
        restore()
    eng = kept[-1]
    verdict = json.load(open(os.path.join(cli_out, "processed.txt")))
    traj_txt = np.loadtxt(os.path.join(cli_out, "trajectory.txt")).reshape(-1, 4, 4)
    reread = load_sens(os.path.join(cli_out, "recorded.sens")).gt_trajectory()
    with open(os.path.join(cli_out, "recorded.ply"), "rb") as fh:
        head = fh.read(400).decode("ascii", "replace")
    triangles = int(head.split("element vertex ")[1].split()[0]) // 3
    out["cli"] = {
        "rc": rc,
        "frames_per_s": verdict["fps"],
        "valid_frames": verdict["numValidOptTransforms"],
        "frames_run": verdict["numTransforms"],
        "ate_rmse_m": verdict.get("ate_rmse_m"),
        "mesh_triangles": triangles,
        "max_keyframes": eng.G,
        "warmup_and_finish_included_s": out.pop("cli_s"),
    }
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}: {log.getvalue()[-2000:]}")
    if not (verdict["numValidOptTransforms"] == verdict["numTransforms"] == n_frames):
        raise AssertionError(f"CLI: {verdict['numValidOptTransforms']} of "
                             f"{verdict['numTransforms']} frames valid ({n_frames} read)")
    if not verdict.get("ate_rmse_m", np.inf) < ATE_MAX_M:
        raise AssertionError(f"CLI ATE RMSE {verdict.get('ate_rmse_m')} m")
    traj = eng.trajectory()
    if not (reread.shape == (n_frames, 4, 4) and np.isfinite(reread).all()
            and np.array_equal(reread, traj) and np.array_equal(traj_txt.astype(np.float32),
                                                                traj)):
        raise AssertionError("the trajectory written into the .sens is not trajectory()")
    if not triangles > 10_000:
        raise AssertionError(f"CLI mesh of {triangles} triangles")

    # ---- 4. render: the raycast beside the splat, at the last pose ----
    pose = traj[n_frames - 1]
    rays, splat = {}, {}
    rays["ms"] = _event_ms(lambda: rays.update(eng.render(pose)))
    splat["ms"] = _event_ms(lambda: splat.update(eng._render(eng.table, pose)))
    for name, r in (("raycast", rays), ("splat", splat)):
        err, hit = _depth_err(r["depth"], seq, n_frames - 1)
        out[name] = {"ms": r["ms"], "median_abs_err_m": err,
                     "hit_share": float(torch.isfinite(r["depth"]).float().mean()),
                     "hit_pixels_compared": hit}
        if not err < 2 * eng.tsdf_params.voxel_size:
            raise AssertionError(f"{name} median |depth - GT| {err} m >= 2 voxels")
    out["raycast"]["ms_repeat"] = _event_ms(lambda: eng.render(pose))
    del eng, kept[:]
    torch.cuda.empty_cache()

    # ---- 5. paging with natural sweeps; a checkpoint midway ----
    radius = PAGE_RADIUS_M
    # a paged-key array the run outgrows: the fusion graphs are captured
    # again when it grows
    paging = dict(streaming_enabled=True, streaming_radius=radius,
                  streaming_every=PAGE_EVERY, streaming_blocked_cap=PAGE_BLOCKED_CAP)
    sweeps = []

    def counted(fn, key):
        def wrapped(table, store, *a, **k):
            n0 = len(store)
            r = fn(table, store, *a, **k)
            sweeps[-1][key] = abs(len(store) - n0)
            return r
        return wrapped

    def sweep_log(inner, eng):
        def run():
            sweeps.append({"frame": eng.frame_idx,
                           "centre_frame": len(eng.sift_world) - 1})
            _sync()
            t0 = time.perf_counter()
            inner()
            _sync()
            sweeps[-1]["ms"] = (time.perf_counter() - t0) * 1e3
            sweeps[-1]["host_blocks"] = len(eng.host_blocks)
            sweeps[-1]["host_mb"] = len(eng.host_blocks) * 5 * 512 * 4 / 1e6
        return run

    # the checkpoint is taken just after the first sweep that has a
    # recorded pose to centre on (the first boundary's frames are
    # recorded at the end of that boundary frame). save() records the
    # open window's frames first, which moves the centre of later sweeps,
    # so the unbroken run records them at the same frame
    first_sweep = next(f for f in range(bundling.submap_size + 1, page_frames)
                       if f % PAGE_EVERY == 0)
    save_at = first_sweep + 1
    undo = [_wrap_attr(streaming, "stream_in", lambda f: counted(f, "in")),
            _wrap_attr(streaming, "stream_out", lambda f: counted(f, "out"))]
    try:
        pag = _recorded_engine(dev, seq, app, bundling, sift_cfg, page_frames, **paging)
        pag._stream_update = sweep_log(pag._stream_update, pag)
        t0 = time.perf_counter()
        _feed(pag, seq, range(save_at))
        pag._flush_pending()
        _feed(pag, seq, range(save_at, page_frames))
        pag.finish()
        _sync()
        out["paging_run_s"] = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    unbroken = {"traj": pag.trajectory(), "flags": list(pag.frame_valid),
                "kf": pag.keyframe_valid.copy(), "payload": _payload_by_key(pag.table),
                "host": sorted(pag.host_blocks.blocks)}
    inv = check_invariants(pag.table)
    out["paging"] = {"radius_m": radius, "every": PAGE_EVERY, "frames": page_frames,
                     "sweeps": sweeps, "host_blocks_end": len(pag.host_blocks),
                     "live_blocks_end": len(unbroken["payload"]),
                     "alloc_failures": int(pag.table.num_alloc_failures),
                     "reint_frames": pag.reint_frames,
                     # the fusion graphs captured again because the paged-key
                     # array grew (it is read by address)
                     "fusion_recaptures": pag.fusion_recaptures,
                     "blocked_capacity": int(pag._blocked_dev.shape[0])}
    if not any(s.get("out", 0) > 0 for s in sweeps):
        raise AssertionError(f"no natural sweep paged a block out: {sweeps}")
    if dev.type == "cuda" and not out["paging"]["fusion_recaptures"]:
        raise AssertionError(f"the paged-key array grew to {out['paging']['blocked_capacity']} "
                             f"and no fusion graph was captured again")
    if any(inv.values()) or int(pag.table.num_alloc_failures):
        raise AssertionError(f"paging run: invariants {inv}, alloc failures "
                             f"{int(pag.table.num_alloc_failures)}")
    del pag
    torch.cuda.empty_cache()

    first = _recorded_engine(dev, seq, app, bundling, sift_cfg, page_frames, **paging)
    _feed(first, seq, range(save_at))
    ckpt = os.path.join(tmp, "engine.npz")
    t0 = time.perf_counter()
    first.save(ckpt)
    save_s = time.perf_counter() - t0
    host_before = {k: v[1].copy() for k, v in first.host_blocks.blocks.items()}
    del first
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed = online.BundleFusion.load(ckpt, device=dev)
    _sync()
    load_s = time.perf_counter() - t0
    host_kept = (list(resumed.host_blocks.blocks) == list(host_before) and all(
        np.array_equal(resumed.host_blocks.blocks[k][1], w) for k, w in host_before.items()))
    out["checkpoint"] = {"saved_at_frame": save_at, "bytes": os.path.getsize(ckpt),
                         "save_s": save_s, "load_s": load_s,
                         "host_blocks_saved": len(host_before)}
    os.remove(ckpt)
    _feed(resumed, seq, range(save_at, page_frames))
    resumed.finish()
    payload = _payload_by_key(resumed.table)
    same_keys = payload.keys() == unbroken["payload"].keys()
    diffs = {
        "trajectory": not np.array_equal(resumed.trajectory(), unbroken["traj"],
                                         equal_nan=True),
        "frame_valid": list(resumed.frame_valid) != unbroken["flags"],
        "keyframe_valid": not np.array_equal(resumed.keyframe_valid, unbroken["kf"]),
        "host_keys": sorted(resumed.host_blocks.blocks) != unbroken["host"],
        "table_keys": not same_keys,
        "payload_rows": sum(1 for k, v in unbroken["payload"].items() if k in payload and not (
            np.array_equal(payload[k][0], v[0]) and np.array_equal(payload[k][1], v[1]))),
    }
    same = not any(diffs.values())
    out["checkpoint"]["resume_bitwise_equal"] = same
    out["checkpoint"]["host_blocks_kept"] = host_kept
    if not host_kept or not len(host_before):
        raise AssertionError(f"the host store did not survive the checkpoint "
                             f"({len(host_before)} blocks saved)")
    if not same:
        raise AssertionError(f"the resumed paging run differs from the unbroken one: {diffs}")
    del resumed, unbroken, payload
    torch.cuda.empty_cache()

    # ---- the contract of tests/test_streaming_engine.py: a
    # re-integration over a paged region against a never-paged twin ----
    con = _recorded_engine(dev, seq, app, bundling, sift_cfg, page_frames,
                           streaming_enabled=True, streaming_radius=6.0)
    twin = _recorded_engine(dev, seq, app, bundling, sift_cfg, page_frames)
    for e in (con, twin):
        _feed(e, seq, range(page_frames))
        e._flush_pending()
    far = np.eye(4, dtype=np.float32)
    far[:3, 3] = [50.0, 0.0, 0.0]
    con.sift_world.append(far)
    con._stream_update()
    paged = len(con.host_blocks)
    con.sift_world[-1] = con.sift_world[0].copy()
    for e in (con, twin):
        poses = np.stack(e.complete_traj)
        valid = np.isfinite(poses).all(axis=(1, 2))
        valid[0] = False
        e.traj_manager.update_optimized_transforms(poses, valid)
        e._tsdf_dispatch()
    left_after_rows = len(con.host_blocks)
    con._stream_update()
    # a block allocated but never fused that sat on the host during the
    # dispatch escaped its garbage collection (the reference's paging
    # does the same); empty blocks hold no volume, so both are collected
    # before the volumes are compared
    empty = [int(((e.table.weight.amax(dim=1) <= 0) & (e.table.slot_keys != EMPTY_KEY)).sum())
             for e in (con, twin)]
    for e in (con, twin):
        garbage_collect(e.table)
    pa, pb = _payload_by_key(con.table), _payload_by_key(twin.table)
    w_equal = pa.keys() == pb.keys() and all(np.array_equal(pa[k][1], pb[k][1]) for k in pa)
    sdf_err = max((float(np.abs(pa[k][0] - pb[k][0]).max()) for k in pa if k in pb),
                  default=float("inf"))
    inv = check_invariants(con.table)
    out["paging_contract"] = {"paged_out": paged, "paged_in_for_rows": paged - left_after_rows,
                              "host_blocks_end": len(con.host_blocks),
                              "empty_blocks_collected": {"paged": empty[0],
                                                         "never_paged": empty[1]},
                              "keys_equal": pa.keys() == pb.keys(), "weights_equal": w_equal,
                              "sdf_max_abs_err": sdf_err,
                              "alloc_failures": int(con.table.num_alloc_failures)}
    if not paged or len(con.host_blocks) or not w_equal or not sdf_err <= SDF_ATOL:
        raise AssertionError(f"paged and never-paged volumes differ: "
                             f"{out['paging_contract']}")
    if any(inv.values()) or int(con.table.num_alloc_failures):
        raise AssertionError(f"contract: invariants {inv}, alloc failures "
                             f"{int(con.table.num_alloc_failures)}")
    del con, twin, pa, pb
    torch.cuda.empty_cache()


MESH_RANKS = 2         # phase_mesh: gloo ranks on cuda:0
MESH_POSE_ATOL = 2e-3  # sharded vs single-device solve (tests/test_sharded.py)


def _mesh_solver(mesh, dev, n):
    """(a) ``solve_sparse_sharded`` on the ring graph of phase_solver_width
    (``n`` poses) against the single-device PCG solve (rank 0 computes that
    too)."""
    from bundlefusion_tpu_torch.io.synthetic import ring_pose_graph
    from bundlefusion_tpu_torch.parallel.ba_sharded import (
        make_replicated_chunk_solver,
        shard_corrs,
        solve_sparse_sharded,
    )
    from bundlefusion_tpu_torch.parallel.mesh import barrier
    from bundlefusion_tpu_torch.solver import gn_pcg
    from bundlefusion_tpu_torch.solver.residuals import corr_store_from_numpy

    gt, arrays = ring_pose_graph(n, 16, 3)
    rng = np.random.default_rng(0)
    init = gt + rng.normal(size=gt.shape).astype(np.float32) * 0.01
    init[0] = gt[0]
    store = corr_store_from_numpy(arrays, dev)
    local = shard_corrs(store, mesh)
    poses0 = torch.as_tensor(init, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    params = gn_pcg.SolverParams(num_gn=3, num_pcg=60, max_pairs=4096, linear="pcg")
    solve_sparse_sharded(poses0, valid, local, mesh, params)        # first-call set-up
    barrier(mesh)
    _sync()
    mesh.reset_stats()
    t0 = time.perf_counter()
    out, cost = solve_sparse_sharded(poses0, valid, local, mesh, params)
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    st = dict(mesh.stats)
    chunk, dropped = make_replicated_chunk_solver(mesh, n, store.capacity, params)(
        poses0, valid, store)
    res = {"frames": n, "corrs": int(arrays["count"]), "ms": ms, "final_cost": float(cost),
           "initial_cost": float(gn_pcg.cost(poses0, store)), "pairs_dropped": int(dropped),
           "chunk_solver_max_abs_diff": float((chunk - out).abs().max()),
           "max_abs_pose_err_vs_gt": float((out - torch.as_tensor(gt, device=dev)).abs().max()),
           "collectives": st["calls"],
           "host_staged_bytes": st["host_staged_bytes"]}
    p_local = min(params.max_pairs, store.capacity // mesh.size)
    res["all_gather_bytes_per_gn_step_sent"] = p_local * 156 * 4
    res["all_gather_bytes_per_gn_step_received"] = p_local * 156 * 4 * mesh.size
    res["all_gather_bytes_per_solve_sent"] = st["all_gather_bytes"]
    if mesh.is_root:
        ref, _ = gn_pcg.solve_sparse(poses0, valid, store, params)
        res["max_abs_pose_diff_vs_single_pcg"] = float((out - ref).abs().max())
    return res


def _mesh_map(mesh, dev, seq, noisy, gt, app, bundling):
    """(b) ``make_sharded_apply`` at the default table against the
    single-table op (kernels) after a gather, at 11 ops and at 1 op."""
    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.parallel.map_sharded import (
        gather_payload,
        make_sharded_apply,
        shard_table_payload,
    )
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.tsdf.apply_ops import apply_tsdf_ops
    from bundlefusion_tpu_torch.tsdf.integrate import candidate_keys
    from bundlefusion_tpu_torch.tsdf.table import allocate_packed

    eng = BundleFusion(seq["intrinsics"], app, bundling, max_keyframes=2, device=dev)
    intr, params = eng.intr_int, eng.tsdf_params
    depths, colors = [], []
    for i in range(6):
        _, _, d, c = eng._archive_frame(seq["depth"][i], seq["color"][i], i)
        depths.append(d)
        colors.append(c)
        for T in (noisy[i], gt[i]):
            allocate_packed(eng.table, candidate_keys(d, intr, torch.as_tensor(T, device=dev),
                                                      params))
    D, C = torch.stack(depths), torch.stack(colors)
    P_noisy = torch.as_tensor(noisy[:6], device=dev)
    P_gt = torch.as_tensor(gt[:6], device=dev)
    base = eng.table
    apply_tsdf_ops(base, D[:5], C[:5], P_noisy[:5], [1.0] * 5, list(range(5)), intr, params)
    batches = {
        "1op": (D[5:6].contiguous(), C[5:6].contiguous(), P_noisy[5:6], [1.0], [0]),
        "11op": (D, C, torch.cat([torch.stack([P_noisy[:5], P_gt[:5]], 1).reshape(10, 4, 4),
                                  P_noisy[5:6]]),
                 [-1.0, 1.0, -1.0, 1.0, 0.0, 0.0, -1.0, 1.0, -1.0, 1.0, 1.0],
                 [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5]),
    }
    apply = make_sharded_apply(mesh, base.num_blocks, intr, params)
    out = {"rows_per_rank": base.num_blocks // mesh.size}
    launches = dict.fromkeys(TSDF_KERNELS, 0)
    for name, batch in batches.items():
        ref = base.clone()
        apply_tsdf_ops(ref, *batch, intr, params)
        shard = shard_table_payload(base, mesh)
        apply(shard, *batch)                                       # first call
        shard = shard_table_payload(base, mesh)
        before = dict(kernels.launch_counts)
        _sync()
        t0 = time.perf_counter()
        apply(shard, *batch)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        for k in launches:
            launches[k] += kernels.launch_counts[k] - before[k]
        full = gather_payload(shard, mesh)
        err = -1.0
        if mesh.is_root:
            got = dataclasses.replace(ref, sdf=full["sdf"], weight=full["weight"],
                                      color=full["color"])
            err = _compare(got, ref)
        out[name] = {"ms": ms, "max_abs_err": err}
        del ref, shard, full
        torch.cuda.empty_cache()
    out["launches"] = launches
    del eng, base
    torch.cuda.empty_cache()
    return out


def _mesh_engine(mesh, dev, seq, gt, app, cfg):
    """(c) the engine with ``mesh=`` through its public entry points."""
    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse

    bundling, n_frames = cfg["bundling"], cfg["n_frames"]
    sub_len = bundling.submap_size
    eng = BundleFusion(seq["intrinsics"], app, bundling, sift_cfg=cfg["sift_cfg"],
                       max_keyframes=cfg["max_keyframes"], mesh=mesh)
    warm_s = eng.warmup()
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_stats()
    frame_ms, boundary, agree = [], [], []
    handle = eng.upload_frame(seq["depth"][0], seq["color"][0])
    for f in range(n_frames):
        is_boundary = f > 0 and f % sub_len == 0
        # a wait around every stage of a boundary frame only: its split
        eng.timing.sync = _sync if is_boundary else None
        b0 = dict(mesh.stats)
        _sync()
        t0 = time.perf_counter()
        nxt = (eng.upload_frame(seq["depth"][f + 1], seq["color"][f + 1])
               if f + 1 < n_frames else None)
        eng.process_frame(handle)
        _sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        handle = nxt
        if is_boundary:
            boundary.append({"frame": f, "broadcast_bytes": mesh.stats["broadcast_bytes"]
                             - b0["broadcast_bytes"],
                             "all_gather_bytes": mesh.stats["all_gather_bytes"]
                             - b0["all_gather_bytes"],
                             "collectives": mesh.stats["calls"] - b0["calls"]})
            agree.append(eng.replicas_agree())
    eng.timing.sync = _sync
    t0 = time.perf_counter()
    eng.finish()
    _sync()
    finish_ms = (time.perf_counter() - t0) * 1e3
    agree.append(eng.replicas_agree())
    samples = eng.timing._samples

    def per_boundary(name):
        return [v * 1e3 for v in samples.get(name, [])]

    local = [a + b + c for a, b, c in zip(per_boundary("time_submap_local_solve"),
                                          per_boundary("time_submap_verify"),
                                          per_boundary("time_submap_fuse"))]
    out = {
        "rank": mesh.rank,
        "replicas_agree": agree,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "warmup_s": warm_s,
        "boundary_broadcast_ms": per_boundary("time_submap_broadcast"),
        "boundary_match_chunk_ms": per_boundary("time_submap_global_match"),
        "boundary_sharded_solve_ms": per_boundary("time_submap_global_solve"),
        "boundary_prune_ms": per_boundary("time_submap_prune"),
        "boundary_collectives": boundary,
        "launches": dict(kernels.launch_counts),
    }
    if mesh.is_root:
        traj = eng.trajectory()
        ate, n_ate = evaluate_ate_rmse(traj, gt[:n_frames])
        plain = [f for f in range(1, n_frames) if f % sub_len]
        out.update({
            "frames": n_frames, "valid_frames": int(sum(eng.frame_valid)),
            "ate_rmse_m": ate, "ate_frames": n_ate, "submaps": eng.num_keyframes,
            "keyframes_valid": int(eng.keyframe_valid[:eng.num_keyframes].sum()),
            "pairs_dropped_total": eng.pairs_dropped_total,
            "boundary_local_phase_ms": local,
            "frames_per_s": n_frames / (sum(frame_ms) / 1e3),
            "frame_ms_median": statistics.median(frame_ms[f] for f in plain),
            "frame_ms_boundary": [frame_ms[f] for f in range(sub_len, n_frames, sub_len)],
            "finish_ms": finish_ms,
        })
    del eng
    torch.cuda.empty_cache()
    return out


def _mesh_rank(mesh, seq, noisy, gt, app, cfg):
    """What each rank of phase_mesh runs: (a), (b), (c) in turn."""
    dev = mesh.device
    marks = [time.perf_counter()]
    res = {"solver": _mesh_solver(mesh, dev, cfg["solver_frames"])}
    marks.append(time.perf_counter())
    res["map"] = _mesh_map(mesh, dev, seq, noisy, gt, app, cfg["bundling"])
    marks.append(time.perf_counter())
    res["engine"] = _mesh_engine(mesh, dev, seq, gt, app, cfg)
    marks.append(time.perf_counter())
    res["parts_s"] = [b - a for a, b in zip(marks, marks[1:])]
    return res


def phase_mesh(seq, noisy, gt, app, ate_single, bundling=None, sift_cfg=None,
               max_keyframes=None, n_frames=N_FRAMES, solver_frames=1200, ranks=MESH_RANKS,
               device="cuda:0"):
    """The multi-device path on ``ranks`` gloo ranks on one card, spawned
    once (the kernels are built before); see the module docstring.
    ``bundling`` / ``sift_cfg`` / ``max_keyframes`` default to the engine's.
    Returns the ``{"mesh"}`` line's dict; raises on a failed check."""
    from bundlefusion_tpu_torch.config import BundlingConfig
    from bundlefusion_tpu_torch.parallel.mesh import run_ranks

    bundling = bundling or BundlingConfig()
    cfg = {"bundling": bundling, "sift_cfg": sift_cfg, "max_keyframes": max_keyframes,
           "n_frames": n_frames, "solver_frames": solver_frames}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wire = {k: seq[k] for k in ("depth", "color", "intrinsics")}
    res = run_ranks(_mesh_rank, ranks, wire, noisy, gt, app, cfg, backend="gloo",
                    device=device, timeout=900)
    spawn_s = time.perf_counter() - t0
    r0 = res[0]
    sol, mp, en = r0["solver"], r0["map"], r0["engine"]
    if not (sol["pairs_dropped"] == 0 and sol["final_cost"] < 1e-3 * sol["initial_cost"]
            and sol["max_abs_pose_diff_vs_single_pcg"] <= MESH_POSE_ATOL
            and sol["chunk_solver_max_abs_diff"] <= 1e-6):
        raise AssertionError(f"phase_mesh (a): sharded solve {sol}")
    if not all(r["solver"]["final_cost"] == sol["final_cost"] for r in res):
        raise AssertionError("phase_mesh (a): the ranks' costs differ")
    for r in res:
        if not all(n > 0 for n in r["map"]["launches"].values()):
            raise AssertionError(f"phase_mesh (b): rank {r['engine']['rank']} launched "
                                 f"{r['map']['launches']}")
        if not all(r["engine"]["replicas_agree"]):
            raise AssertionError(f"phase_mesh (c): replicas differ {r['engine']['replicas_agree']}")
    if not (en["valid_frames"] == n_frames and en["ate_frames"] == n_frames
            and en["ate_rmse_m"] < ATE_MAX_M):
        raise AssertionError(f"phase_mesh (c): {en['valid_frames']} valid, ATE {en['ate_rmse_m']}")
    want = -(-(n_frames - 1) // bundling.submap_size)
    if en["submaps"] != want or en["keyframes_valid"] < want - 1:
        raise AssertionError(f"phase_mesh (c): {en['submaps']} submaps, "
                             f"{en['keyframes_valid']} keyframes valid")
    if not all(n > 0 for n in en["launches"].values()):
        raise AssertionError(f"phase_mesh (c): rank 0 launched {en['launches']}")
    return {
        "ranks": ranks, "backend": "gloo", "device": device, "spawn_s": spawn_s,
        "parts_s": [r["parts_s"] for r in res],
        "solver": {**sol, "ms_per_rank": [r["solver"]["ms"] for r in res]},
        "map": {**mp, "launches_per_rank": [r["map"]["launches"] for r in res]},
        "engine": {**en, "ate_rmse_m_single_device": ate_single,
                   "peak_mem_gb_per_rank": [r["engine"]["peak_mem_gb"] for r in res],
                   "replicas_agree_per_rank": [r["engine"]["replicas_agree"] for r in res]},
    }


CAPACITY_POSE_ATOL = 1e-4          # phase_capacity (c): card against the CPU
CAPACITY_OVERFLOW = (4096, 1 << 16)  # (max_pairs, max_working_corrs) below the problem's
PAN_FRAMES = 120                     # phase_capacity (e): one turn inside the walled room
PAN_PUSH_AFTER = (30, 60, 90)        # (e): its pushes of the noise-free poses
PAN_MIN_ROWS = 20000                 # (e): live rows at its checked dispatches


def _prune_and_revalidate(dev) -> dict:
    """Part (d) of :func:`phase_capacity`, as ``tests/test_torch_engine.py``
    drives them on the CPU: the drift demo's engine on the first 4 submaps
    of its sequence, with bogus correspondences between keyframes 1 and 0
    (0.58 m apart) appended after the second boundary, which the third
    boundary's prune rounds must remove; then keyframe 1 loses its pose and
    its correspondences and is queued, and the fourth boundary must re-match
    and restore it."""
    from bundlefusion_tpu_torch.io.synthetic import loop_trajectory, make_sequence_wire
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.scripts import drift_demo
    from bundlefusion_tpu_torch.solver.residuals import append_corrs, invalidate_frame
    from bundlefusion_tpu_torch.tsdf.table import check_invariants

    small = dev.type != "cuda"
    intr, app, bundling, sift_cfg, G = drift_demo.configs(small)
    if small:
        # the CPU rehearsal: at the small configuration's 40x30 dense cache
        # a correct submap fails verify as often as not (ROADMAP Queue 3)
        bundling = dataclasses.replace(bundling, downsampled_width=80, downsampled_height=60)
    sub = bundling.submap_size
    n = 4 * sub + 1
    seq = make_sequence_wire(n, intr=intr, poses=loop_trajectory(41 if small else 241)[:n],
                             noise_depth=drift_demo.NOISE, device=dev)
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=G, device=dev)
    eng.warmup()
    reval = drift_demo.RevalidationLog(eng)
    for f in range(2 * sub + 1):
        eng.process_frame(seq["depth"][f], seq["color"][f])
    K = 8
    rng = np.random.default_rng(0)
    p_i = rng.uniform(-0.5, 0.5, (K, 3)).astype(np.float32) + np.float32([0, 0, 1.5])
    c0 = int(eng.glob.corrs.count)
    append_corrs(eng.glob.corrs, torch.full((K,), 1, dtype=torch.int32, device=dev),
                 torch.zeros(K, dtype=torch.int32, device=dev), torch.from_numpy(p_i).to(dev),
                 torch.from_numpy(p_i + np.float32([0.5, 0.3, 0.0])).to(dev),
                 torch.ones(K, dtype=torch.bool, device=dev))
    for f in range(2 * sub + 1, 3 * sub + 1):
        eng.process_frame(seq["depth"][f], seq["color"][f])
    injected_live = int((eng.glob.corrs.img_i[c0:c0 + K] >= 0).sum())
    invalidate_frame(eng.glob.corrs, 1)
    eng.glob.keys.frame_valid[1] = False
    eng.keyframe_valid[1] = False
    eng.kf_valid_dev[1] = False
    if 1 not in eng.retry_list:
        eng.retry_list.append(1)
    for f in range(3 * sub + 1, n):
        eng.process_frame(seq["depth"][f], seq["color"][f])
    eng.finish()
    out = {
        "frames": n, "prune_rounds_per_boundary": [s["prune_rounds"] for s in eng.boundary_stats],
        "injected_rows_left": injected_live,
        "revalidations": {"attempted": reval.attempted, "succeeded": reval.succeeded},
        "keyframes_valid": int(eng.keyframe_valid[: eng.num_keyframes].sum()),
        "keyframes": eng.num_keyframes, "retry_list": list(eng.retry_list),
        "valid_frames": int(np.isfinite(eng.trajectory()).all((1, 2)).sum()),
        "invariants": {k: int(v) for k, v in check_invariants(eng.table).items()},
    }
    if not (out["prune_rounds_per_boundary"][2] >= 1 and injected_live == 0):
        raise AssertionError(f"phase_capacity (d): the bogus pair was not pruned: {out}")
    if not (reval.succeeded >= 1 and bool(eng.keyframe_valid[1]) and 1 not in eng.retry_list):
        raise AssertionError(f"phase_capacity (d): keyframe 1 was not revalidated: {out}")
    if any(out["invariants"].values()):
        raise AssertionError(f"phase_capacity (d): invariants {out['invariants']}")
    return out


def _large_table(dev) -> dict:
    """Part (e) of :func:`phase_capacity`: the TSDF kernels at tens of
    thousands of live rows. The engine's fusion half, as ``phase_slice``
    drives it, over one turn on the spot inside the port's walled room
    (``io/synthetic.py`` ``room_scene``, ``pan_trajectory``: walls, floor
    and ceiling come into view) at the drift demo's card configuration
    (640x480 input, 320x240 integration, 131 072 blocks), on the card and
    in a rehearsal on the CPU alike: each frame archived, fused at its pose
    with 1 cm of noise and rendered; the noise-free poses pushed after the
    frames of ``PAN_PUSH_AFTER`` and at the end (every frame so far
    re-integrated), then the drain. The op is held against its plain
    version, and timed beside it, at the first 1-op and multi-op dispatch
    once the table holds ``PAN_MIN_ROWS`` live rows."""
    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.io.synthetic import make_sequence_wire, pan_trajectory, room_scene
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.scripts import drift_demo

    intr, app, bundling, _, _ = drift_demo.configs(small=False)
    gt = pan_trajectory(PAN_FRAMES)
    noisy = gt.copy()
    noisy[:, :3, 3] += np.random.default_rng(0).normal(
        scale=0.01, size=(PAN_FRAMES, 3)).astype(np.float32)
    seq = make_sequence_wire(PAN_FRAMES, intr=intr, scene=room_scene(dev), poses=gt,
                             device=dev)
    eng = BundleFusion(intr, app, bundling, max_keyframes=PAN_FRAMES // 10 + 2, device=dev)
    checker = _check_apply(eng, min_rows=PAN_MIN_ROWS)
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    t0 = time.perf_counter()
    for i in range(PAN_FRAMES):
        _drive_frame(eng, seq, noisy, gt, i, lambda _name, fn: fn(), PAN_PUSH_AFTER)
    eng.frame_idx = PAN_FRAMES
    eng.complete_traj = [gt[f].copy() for f in range(PAN_FRAMES)]
    eng._push_optimized_to_manager()
    eng._drain_reintegration()
    _sync()
    loop_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    med_err, hit = _depth_err(eng._render(eng.table, gt[-1])["depth"], seq, PAN_FRAMES - 1)
    out = {"frames": PAN_FRAMES, "loop_s": loop_s, "tsdf_dispatches": checker.dispatches,
           **drift_demo.engine_health(eng), "render_median_abs_err_m": med_err,
           "render_hit_pixels": hit, "launches": launches, "checks": checker.checked}
    if set(checker.checked) != {"fast", "rows"}:
        raise AssertionError(f"phase_capacity (e): no dispatch checked at {PAN_MIN_ROWS} "
                             f"live rows: {out}")
    if any(out["invariants"].values()) or out["alloc_failures"]:
        raise AssertionError(f"phase_capacity (e): invariants or allocation failures: {out}")
    if not _fusion_launches_ok(launches, checker.dispatches):
        raise AssertionError(f"phase_capacity (e): launches != TSDF dispatches: {out}")
    if not med_err < 2 * eng.tsdf_params.voxel_size:
        raise AssertionError(f"phase_capacity (e): render median |depth - GT| {med_err} m")
    return out


def phase_capacity(dev, boundary_g=640, per_pair=25, overflow=CAPACITY_OVERFLOW):
    """The long-run and capacity path; see the module docstring. On the CPU
    (a rehearsal) ``boundary_g`` / ``per_pair`` / ``overflow`` shrink the
    sizes (the drift demo takes its CPU size by itself). Returns the ``{"capacity"}`` line's dict; raises on a
    failed check."""
    import shutil
    import tempfile

    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.scripts import drift_demo, profile_boundary

    tmp = tempfile.mkdtemp(prefix="bf_capacity_")
    base = ["--out", tmp] + (["--device", dev.type] if dev.type != "cuda" else [])
    out = {}
    try:
        # ---- (a) the drift demo, its TSDF op held against its plain
        # version at its first 1-op and 11-op dispatch, the kernels' counts
        # set to 0 after its warm-up ----
        checkers = []

        def hook(eng):
            checkers.append(_check_apply(eng))
            for name in kernels.launch_counts:
                kernels.launch_counts[name] = 0

        t0 = time.perf_counter()
        demo = drift_demo.main(base, hook=hook)
        launches = dict(kernels.launch_counts)
        checker = checkers.pop()
        torch.cuda.empty_cache()
        if any(demo["invariants"].values()) or demo["alloc_failures"]:
            raise AssertionError(f"phase_capacity (a): invariants {demo['invariants']}, "
                                 f"alloc failures {demo['alloc_failures']}")
        if set(checker.checked) != {"fast", "rows"}:
            raise AssertionError(f"phase_capacity (a): dispatches checked {checker.checked}")
        if any(n == 0 for n in launches.values()) or set(launches) != set(kernels.SOURCES):
            raise AssertionError(f"phase_capacity (a): a TSDF kernel was never launched: "
                                 f"{launches}")
        out["drift_demo"] = {**demo, "phase_s": time.perf_counter() - t0}
        out["launches"] = launches
        out["main_path_checks"] = checker.checked
        del checker

        # ---- (b) one boundary at G = 640, part by part ----
        t0 = time.perf_counter()
        pb = profile_boundary.main(base + [str(boundary_g), str(per_pair)])
        if not (pb["dropped"] == 0 and np.isfinite(pb["max_residual"])
                and pb["max_residual"] < 1e-3 and pb["cost_final"] < pb["cost_initial"]):
            raise AssertionError(f"phase_capacity (b): {pb}")
        out["boundary"] = {**pb, "phase_s": time.perf_counter() - t0}

        # ---- (c) the same problem past both working-set caps, on the card
        # and on the CPU ----
        t0 = time.perf_counter()
        problem = profile_boundary.build_problem(boundary_g, per_pair, np.random.default_rng(0))
        params = profile_boundary.solver_params(*overflow)
        card = profile_boundary.boundary_calls(problem, params, dev)
        host = profile_boundary.boundary_calls(problem, params, torch.device("cpu"))
        live = card["working_valid"]
        pairs_kept = len({(int(i), int(j)) for i, j in zip(card["working_img_i"][live],
                                                            card["working_img_j"][live])})
        same_set = all(np.array_equal(card[k], host[k])
                       for k in ("working_img_i", "working_img_j", "working_valid"))
        pose_err = max(float(np.abs(card[k] - host[k]).max())
                       for k in ("poses", "poses_after_prune"))
        out["overflow"] = {
            "max_pairs": params.max_pairs, "max_working_corrs": params.max_working_corrs,
            "corrs": problem["corrs"], "pairs": problem["pairs"],
            "working_rows": int(live.sum()), "pairs_in_working_set": pairs_kept,
            "dropped": card["dropped"], "dropped_cpu": host["dropped"],
            "working_set_equal": same_set, "worst_pair": card["worst_pair"],
            "worst_pair_cpu": host["worst_pair"], "max_abs_pose_diff_vs_cpu": pose_err,
            "times_ms": card["times"], "phase_s": time.perf_counter() - t0,
        }
        if not (problem["corrs"] > params.max_working_corrs and pairs_kept > params.max_pairs):
            raise AssertionError(f"phase_capacity (c): not both overflow regimes: "
                                 f"{out['overflow']}")
        if not (card["dropped"] == host["dropped"] > 0 and same_set
                and pose_err <= CAPACITY_POSE_ATOL):
            raise AssertionError(f"phase_capacity (c): card and CPU differ: {out['overflow']}")

        # ---- (d) the engine's prune round and a won revalidation ----
        t0 = time.perf_counter()
        out["prune_and_revalidate"] = _prune_and_revalidate(dev)
        out["prune_and_revalidate"]["phase_s"] = time.perf_counter() - t0

        # ---- (e) the TSDF kernels at tens of thousands of live rows ----
        t0 = time.perf_counter()
        out["large_table"] = _large_table(dev)
        out["large_table"]["phase_s"] = time.perf_counter() - t0
    except Exception:
        print(f"chip_smoke: phase_capacity so far: {json.dumps(out, default=str)[:20000]}",
              file=sys.stderr)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


BENCH_TIMEOUT_S = 400   # the bench command's time limit (its child is killed then)
# the bench with ``_frame_step`` and the fusion programs run eagerly (the
# engine's private switches): ``python -c EAGER_BENCH --cache DIR``
EAGER_BENCH = """import sys
from bundlefusion_tpu_torch.pipeline import online
online.BundleFusion._eager_frame_step = True
online.BundleFusion._eager_fusion = True
from bundlefusion_tpu_torch import bench
bench.main(sys.argv[1:])
"""
# ... and with the greedy filter's plain version patched in (the package has
# no switch for it; it reads the card, so the step runs eagerly, and the
# fusion with it)
PLAIN_BENCH = """import sys
from bundlefusion_tpu_torch.ops import filters
from bundlefusion_tpu_torch.pipeline import frontend, online
frontend.kabsch_filter = filters.kabsch_filter_ref
online.BundleFusion._eager_frame_step = True
online.BundleFusion._eager_fusion = True
from bundlefusion_tpu_torch import bench
bench.main(sys.argv[1:])
"""
BENCH_KEYS = ("value", "ms_per_frame", "fps_streaming", "valid_frames", "pairs_dropped",
              "ate_rmse_cm", "reint_frames", "reint_ops", "reint_frames_timed",
              "reint_ops_timed", "stage_ms", "stage_dev_ms", "kernel_launches", "compile_s",
              "peak_mem_gb", "phase_s")


def _bench_child(cache, mode="graph") -> dict:
    """One run of the bench command in a child process, ``mode`` "graph"
    (as it is), "eager" or "plain"; its last line."""
    import os

    cmd = {"graph": ["-m", "bundlefusion_tpu_torch.bench"], "eager": ["-c", EAGER_BENCH],
           "plain": ["-c", PLAIN_BENCH]}[mode]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, *cmd, "--cache", cache],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"phase_bench: the bench ({mode}) exited {proc.returncode}:\n"
                           f"{proc.stderr[-8000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    line["phase_s"] = time.perf_counter() - t0
    return line


def phase_bench() -> dict:
    """The port's bench command, ``python -m bundlefusion_tpu_torch.bench``,
    in a child process: it loads its kernels and runs on its own, at its
    card configuration (``bench.py``'s operating point). Its sequence is
    cached in a temporary directory. Returns its last line's dict; raises
    unless the command exits 0 on the card with every frame of its windows
    (108) valid, no pair dropped, the ATE under ``ATE_MAX_M`` and every
    kernel launched. Then, in turns, the same command with ``_frame_step``
    run eagerly, with the greedy filter's plain version patched in (eager)
    and once more as it is: their main numbers go under ``eager``,
    ``plain_filter`` and ``graph_again``. The eager and the second graph run
    are held to the same checks, and the plain run must keep every frame
    valid and launch no greedy-filter kernel."""
    import shutil
    import tempfile

    from bundlefusion_tpu_torch import bench, kernels

    n_frames = bench.configure(torch.device("cuda"))[-1].total

    torch.cuda.empty_cache()   # leave the child the memory the earlier phases cached
    tmp = tempfile.mkdtemp(prefix="bf_bench_")
    try:
        line = _bench_child(tmp)
        eager = _bench_child(tmp, "eager")
        plain = _bench_child(tmp, "plain")
        again = _bench_child(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = []
    for name, run in (("graph", line), ("eager", eager), ("graph again", again)):
        launches = run["kernel_launches"]
        if run["platform"] != "gpu":
            bad.append(f"{name}: platform {run['platform']!r}")
        if not run["valid_frames"] == run["total_frames"] == n_frames:
            bad.append(f"{name}: {run['valid_frames']} of {run['total_frames']} frames valid")
        if run["pairs_dropped"] != 0:
            bad.append(f"{name}: {run['pairs_dropped']} pairs dropped")
        if not run["ate_rmse_cm"] / 100.0 < ATE_MAX_M:
            bad.append(f"{name}: ATE {run['ate_rmse_cm']} cm")
        if set(launches) != set(kernels.SOURCES) or any(n <= 0 for n in launches.values()):
            bad.append(f"{name}: kernel launches {launches}")
    if plain["valid_frames"] != n_frames or plain["kernel_launches"]["kabsch_filter"]:
        bad.append(f"plain filter run: {plain['valid_frames']} valid, launches "
                   f"{plain['kernel_launches']}")
    if bad:
        raise AssertionError(f"phase_bench: {'; '.join(bad)}: {json.dumps(line)}")
    line["eager"] = {k: eager[k] for k in BENCH_KEYS}
    line["plain_filter"] = {k: plain[k] for k in BENCH_KEYS}
    line["graph_again"] = {k: again[k] for k in BENCH_KEYS}
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the card",
              file=sys.stderr)
        return 1
    import bundlefusion_tpu_torch  # noqa: F401  (turns TF32 off before any product)
    from bundlefusion_tpu_torch.config import AppConfig
    from bundlefusion_tpu_torch.io.synthetic import (
        default_intrinsics,
        make_sequence_wire,
        orbit_trajectory,
    )
    from bundlefusion_tpu_torch.scripts import common

    dev = torch.device("cuda")
    gpu = common.gpu_line()
    build_s, ptxas = phase_build()
    t0 = time.perf_counter()
    seq = make_sequence_wire(N_FRAMES, intr=default_intrinsics(640, 480), device=dev)
    seq_s = time.perf_counter() - t0
    gt = orbit_trajectory(N_FRAMES)
    noisy = orbit_trajectory(N_FRAMES, noise=0.01)

    app = AppConfig()
    kern = phase_kernels(dev, seq, noisy, gt, app)
    kab = phase_kabsch(dev, seq, app)
    sa = phase_surface_area(dev, seq, app)
    sl = phase_slice(dev, seq, noisy, gt, app)
    prof = phase_profile(dev, seq, noisy, gt, app)
    t0 = time.perf_counter()
    fe = phase_frontend(dev, seq, gt, app)
    fe["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    en = phase_engine(dev, seq, gt, app)
    en["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = phase_recorded(dev, seq, gt, app)
    rec["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    en["solver_at_width"] = phase_solver_width(dev)
    en["solver_at_width"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = phase_mesh(seq, noisy, gt, app, en["ate_rmse_m"])
    mesh["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cap = phase_capacity(dev)
    cap["phase_s"] = time.perf_counter() - t0
    bench = phase_bench()
    main_errs = [c["max_abs_err"] for c in sl["main_path_checks"].values()]
    main_errs += [c["max_abs_err"] for c in en["main_path_checks"].values()]
    main_errs += [c["max_abs_err"] for c in cap["main_path_checks"].values()]
    main_errs += [c["max_abs_err"] for c in cap["large_table"]["checks"].values()]

    def launches(name, main):
        return {
            "name": name,
            "route": "cuda",
            "source": f"bundlefusion_tpu_torch/kernels/{name}.cu",
            "replaces": REPLACES[name],
            "launches": main,
            "launches_slice": sl["launches"][name],
            "launches_frontend": fe["launches"][name],
            "launches_engine": en["launches"][name],
            "launches_recorded": rec["launches"][name],
            "launches_mesh": mesh["engine"]["launches"][name],
            "launches_capacity": cap["launches"][name],
            "launches_large_table": cap["large_table"]["launches"][name],
            "launches_bench": bench["kernel_launches"][name],
        }

    def entry(name, sub, extra_err=()):
        k11 = kern["11op"][sub] if sub else kern["11op"]
        k1 = kern["1op"][sub] if sub else kern["1op"]
        e = {
            **launches(name, sl["launches"][name]),
            "max_abs_err": max([k11["max_abs_err"], k1["max_abs_err"], *extra_err]),
            "library_ms": None,
        }
        for key in ("ms", "plain_ms", "launch_ms", "enqueue_ms", "kernel_ms", "kernel_ms_cold", "grid_ms",
                    "rows", "rows_plain", "rows_both", "rows_changed", "ops_per_row"):
            if key in k11:
                e[key] = k11[key]
                e[key + "_1op"] = k1[key]
        e["bound_ms"], e["bound_by"] = k11["bound"]
        e["bound_ms_1op"], e["bound_by_1op"] = k1["bound"]
        return e

    def kabsch_entry():
        ks = [kab[str(n)] for n in KABSCH_PAIRS]
        e = {
            # its main path is the per-frame path: phase_frontend's kernel run
            **launches("kabsch_filter", fe["launches"]["kabsch_filter"]),
            "max_abs_err": max(k["max_abs_err"] for k in ks),
            "mismatching_pairs": sum(k["mismatching_pairs"] for k in ks),
            "library_ms": None,
            "plain_card_cpu_split_pairs": sum(k["plain_card_cpu_split_pairs"] for k in ks),
        }
        for n, k in zip(KABSCH_PAIRS, ks):
            sfx = "" if n == KABSCH_PAIRS[0] else f"_{n}"
            for key in ("ms", "plain_ms", "kernel_ms", "plain_host_reads", "pairs",
                        "valid_pairs", "fits", "longest_fits", "us_per_fit"):
                e[key + sfx] = k[key]
            e["bound_ms" + sfx], e["bound_by" + sfx] = k["bound"]
        return e

    def surface_area_entry():
        ks = [sa[str(n)] for n in KABSCH_PAIRS]
        e = {
            # its main path is the per-frame path: phase_frontend's graph run
            **launches("surface_area", fe["launches"]["surface_area"]),
            "max_abs_err": max(k["max_abs_err"] for k in ks),
            "mismatching_pairs": sum(k["mismatching_pairs"] for k in ks),
            "ill_posed_images": sum(k["ill_posed_images"] for k in ks),
            # no single PyTorch call computes the filter; eigh_ms is the
            # batched torch.linalg.eigh of the same covariances
            "library_ms": None,
        }
        for n, k in zip(KABSCH_PAIRS, ks):
            sfx = "" if n == KABSCH_PAIRS[0] else f"_{n}"
            for key in ("ms", "plain_ms", "kernel_ms", "eigh_ms", "pairs", "kept_pairs"):
                e[key + sfx] = k[key]
            e["bound_ms" + sfx], e["bound_by" + sfx] = k["bound"]
        return e

    big = cap["large_table"]["checks"]
    kernels_line = {"kernels": [
        entry("tsdf_prepare", "prepare"),
        entry("tsdf_cull", "cull"),
        {**entry("tsdf_apply", None, main_errs), "live_rows": kern["11op"]["live_rows"],
         "wave_ctas": kern["wave_ctas"],
         # the op (all three kernels) at the large table's checked dispatches
         "large_table": {k: {key: c[key] for key in ("ops", "live_rows", "rows_changed", "ms",
                                                     "plain_ms", "bound", "max_abs_err")}
                         for k, c in big.items()}},
        kabsch_entry(),
        surface_area_entry(),
    ]}
    for e in kernels_line["kernels"]:
        e["ptxas"] = ptxas.get(e["name"], [])
    sl["profile"] = prof
    sl["build_s"] = build_s
    sl["sequence_render_s"] = seq_s
    print(gpu)
    print(json.dumps(kernels_line))
    print(json.dumps({"slice": sl}))
    print(json.dumps({"frontend": fe}))
    print(json.dumps({"engine": en}))
    print(json.dumps({"recorded": rec}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"capacity": cap}))
    print(json.dumps({"bench": bench}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
