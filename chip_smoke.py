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
   time everything in turns;
3. slice: drive the engine over 40 synthetic frames at poses with 1 cm of
   noise, pushing the noise-free poses after frames 10, 20 and 30 (as
   submap retirements do) and at the end, then drain the re-integration
   queue and extract the mesh. The op is held against its plain version
   again at the engine's first 1-op and first 11-op dispatch;
4. profile: 20 more frames of the same loop under ``torch.profiler`` for the
   card's busy share;
5. frontend: the same 40 wire frames through the whole per-frame path in
   the order ``process_frame`` has it, with the engine estimating its own
   poses: ``_frame_step`` (archive, SIFT, stores, matching, the Kabsch ->
   surface-area -> dense-verify cascade, correspondences, chained pose),
   one read-back of pose and validity, the TSDF dispatch, bookkeeping, the
   render; at every 10th frame the window rolls over and the chained pose
   becomes the new window's base. Run once with one wait per frame (frame
   times, checks), once more with a wait around every stage (stage times;
   the validity flags must repeat), then 5 frames of ``_frame_step`` under
   the profiler (launches per frame, busy share) and 2 with a trace and an
   op counter per stage (launches and dispatched ops by stage). It fails
   unless all 40
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
   updates and equals its plain version, all three kernels were launched,
   the render at the last pose is within 2 voxels of the true depth, the
   table's invariants hold, no allocation failed and the mesh has more than
   10 000 triangles;
7. solver at width: ``solve_sparse`` on a ring graph of 1200 poses (every
   pose tied to its 3 predecessors by 16 correspondences, perturbed by
   0.01) with the direct and with the PCG linear step, by CUDA events, and
   the direct step's parts (sort, pair blocks, assembly, the LU alone
   beside its float32 bound). Both must reach 1e-3 of the initial cost.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, a
``{"slice": {...}}`` line, a ``{"frontend": {...}}`` line, an ``{"engine":
{...}}`` line (with ``solver_at_width`` inside) and last ``{"ok": true,
"device": {...}}``. ``launches`` in the kernels line counts the slice phase,
``launches_frontend`` the frontend phase's first run, ``launches_engine``
the engine phase's first run; the counts are set to 0 just before each. In
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
no single PyTorch call computes any of the three. Any failed phase raises
and exits non-zero; without CUDA it exits non-zero before doing anything.

    python3 chip_smoke.py
"""

from __future__ import annotations

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
}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    most of a call this short. None when the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            if before is not None:
                before()
            fn()
        _sync()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    if not hits:
        print(f"chip_smoke: no {kernel} in the profiler trace", file=sys.stderr)
        return None
    return sum(e.self_device_time_total for e in hits) / 1e3 / sum(e.count for e in hits)


def phase_build():
    from bundlefusion_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    for name in kernels.SOURCES:
        kernels.load(name)
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {name}] {line.strip()}")
    return time.perf_counter() - t0


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

    for name, (d, c, p, signs, imgs) in batches.items():
        H, W = d.shape[1:]
        w2c = apply_ops.world_to_camera_rows(p)
        imgs_t = torch.tensor(imgs, device=dev)

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
        row_ops = int(apply_ops.mask_bits(masks[:n], len(signs)).sum())
        live_rows = int((base.slot_keys[:-1] != EMPTY_KEY).sum())
        active = sum(1 for x in signs if x != 0.0)

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

        used_imgs = len({i for i, x in zip(imgs, signs) if x != 0.0})
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
                "bound": _bound(N * 4 + n * 12 + len(signs) * 64 + 4,
                                live_rows * active * 8 * FLOP_PER_CORNER),
            },
        }
    out["wave_ctas"] = wave
    del eng, base, work, ref
    torch.cuda.empty_cache()
    return out


class _CheckedApply:
    """Wraps the engine's TSDF op: counts dispatches and, at the first
    1-op and the first multi-op dispatch, holds the kernel's result against
    the plain version run on a snapshot taken before the call."""

    def __init__(self, eng):
        self.eng = eng
        self.inner = eng._apply_tsdf_ops
        self.dispatches = 0
        self.checked = {}

    def __call__(self, depths, colors, poses, signs, img_of_op):
        from bundlefusion_tpu_torch.tsdf.apply_ops import apply_tsdf_ops_ref

        self.dispatches += 1
        kind = "fast" if poses.shape[0] == 1 else "rows"
        snap = self.eng.table.clone() if kind not in self.checked else None
        self.inner(depths, colors, poses, signs, img_of_op)
        if snap is not None:
            apply_tsdf_ops_ref(snap, depths, colors, poses, signs, img_of_op,
                               self.eng.intr_int, self.eng.tsdf_params)
            _sync()
            self.checked[kind] = {"frame": self.eng.frame_idx, "ops": int(poses.shape[0]),
                                  "max_abs_err": _compare(self.eng.table, snap)}
            del snap


def _drive_frame(eng, seq, noisy, gt, i, stage):
    """Frame ``i`` of the fusion half, each stage run through
    ``stage(name, fn)``; the noise-free poses are pushed after the frames
    of PUSH_AFTER, as submap retirements do."""
    eng.frame_idx = i
    slot = eng._store_slot(i)
    stage("archive", lambda: eng._archive_frame(seq["depth"][i], seq["color"][i], slot))
    stage("tsdf", lambda: eng._tsdf_dispatch(slot, noisy[i], True))
    eng._record_frame(i, noisy[i], True)
    stage("render", lambda: eng._render_frame(i, noisy[i]))
    if i in PUSH_AFTER:
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
    checker = _CheckedApply(eng)
    eng._apply_tsdf_ops = checker  # the instance attribute shadows the method
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

    if checker.dispatches == 0 or set(launches) != set(kernels.SOURCES) or any(
            n != checker.dispatches for n in launches.values()):
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

    def stage(self, attr, ft=None):
        return _CountedStage(self.totals.setdefault(
            attr, {"device_ops": 0, "device_ms": 0.0, "dispatched_ops": 0}))


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


def _drive_frontend_frame(eng, seq, f, stage):
    """Frame ``f`` of the whole per-frame path, in the order ``process_frame``
    has it, each stage run through ``stage(name, fn)``. Frame k * (S-1) is
    slot S-1 of window k-1; after it the window rolls over and the frame's
    chained pose becomes the new window's base (where the solver's pose
    will go). Returns (cur_slot, valid)."""
    sub_len = eng.S - 1
    slot = f % sub_len
    boundary = f > 0 and slot == 0
    cur_slot = sub_len if boundary else slot
    store_slot = eng._store_slot(f)
    eng.frame_idx = f
    T_dev, valid_dev = stage("frame_step", lambda: eng._frame_step(
        seq["depth"][f], seq["color"][f], cur_slot, store_slot))
    T_world, valid = stage("readback", lambda: eng._read_pose(T_dev, valid_dev))
    stage("tsdf", lambda: eng._tsdf_dispatch(store_slot, T_world, valid))
    eng._record_frame(f, T_world, valid)
    stage("render", lambda: eng._render_frame(f, T_world))
    if boundary:
        eng._rollover_local()
        eng.submap_base = T_dev
    return cur_slot, valid


def _stage_ms(log, coarse):
    """Median ms per stage: the engine's ``TimingLog`` and the coarse
    stages timed here."""
    out = {k: v * 1e3 for k, v in log.medians().items()}
    out.update({k: statistics.median(v) * 1e3 for k, v in coarse.items()})
    return out


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

    def engine():
        return BundleFusion(seq["intrinsics"], app, bundling, sift_cfg=sift_cfg,
                            max_keyframes=n_frames // bundling.submap_size + 2, device=dev)

    def drive(eng, stage_syncs):
        """All frames; per-frame wall ms (one wait at the frame's end) and
        the coarse stages' seconds. With ``stage_syncs`` every stage, the
        engine's own included, is closed by a wait for the card."""
        eng.timing.sync = _sync if stage_syncs else None
        coarse = {}

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
            cur_slot, v = _drive_frontend_frame(eng, seq, f, stage)
            _sync()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            valid.append(v)
            # after a rollover the frame sits in slot 0 of the new window
            keys.append(eng.local.keys.valid[0 if cur_slot == eng.S - 1 else cur_slot].sum())
        return frame_ms, valid, coarse, torch.stack(keys).cpu().numpy()

    # ---- run A: one wait per frame; the checks ----
    eng = engine()
    for name in kernels.launch_counts:
        kernels.launch_counts[name] = 0
    torch.cuda.reset_peak_memory_stats()
    frame_ms, valid, coarse_a, keys = drive(eng, stage_syncs=False)
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_ms = _stage_ms(eng.timing, coarse_a)

    ate, n_ate = evaluate_ate_rmse(np.stack(eng.sift_world), gt[:n_frames])
    inv = check_invariants(eng.table)
    fails = int(eng.table.num_alloc_failures)
    med_err, _ = _depth_err(eng.last_render["depth"], seq, n_frames - 1)
    live_corrs = int(eng.local.corrs.valid_mask().sum())
    live_blocks = int((eng.table.slot_keys[:-1] != EMPTY_KEY).sum())

    if not all(valid):
        raise AssertionError(f"frames lost: {[f for f, v in enumerate(valid) if not v]}")
    if any(n == 0 for n in launches.values()) or set(launches) != set(kernels.SOURCES):
        raise AssertionError(f"a TSDF kernel was never launched on the frontend path: {launches}")
    if not (n_ate == n_frames and ate < ATE_MAX_M):
        raise AssertionError(f"chained ATE RMSE {ate} m over {n_ate} frames (limit {ATE_MAX_M})")
    if any(inv.values()) or fails:
        raise AssertionError(f"table invariants {inv}, alloc failures {fails}")
    if not med_err < 2 * eng.tsdf_params.voxel_size:
        raise AssertionError(f"render median |depth - GT| {med_err} m >= 2 voxels")
    del eng
    torch.cuda.empty_cache()

    # ---- run B: a wait around every stage; the flags must repeat ----
    eng = engine()
    with _FrontendProbe() as probe:
        frame_ms_b, valid_b, coarse_b, _ = drive(eng, stage_syncs=True)
    if valid_b != valid:
        raise AssertionError(f"validity flags differ between two runs: {valid} vs {valid_b}")
    stats = probe.summary()
    if stats["valid_pairs_per_frame_min"] < 1:
        raise AssertionError("a frame after the first had no valid pair")
    stage_ms = _stage_ms(eng.timing, coarse_b)
    ate_b, _ = evaluate_ate_rmse(np.stack(eng.sift_world), gt[:n_frames])
    del eng
    torch.cuda.empty_cache()

    # ---- run C: _frame_step alone under the profiler ----
    eng = engine()
    first = min(n_frames - FRONTEND_PROFILE_FRAMES - 2, bundling.submap_size + 1)
    for f in range(first):
        _drive_frontend_frame(eng, seq, f, lambda _name, fn: fn())
    _sync()
    sub_len = eng.S - 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(first, first + FRONTEND_PROFILE_FRAMES):
            eng._frame_step(seq["depth"][f], seq["color"][f], f % sub_len, eng._store_slot(f))
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in evs) / 1e3
    if not device_ms > 0:
        raise AssertionError("the profiler's trace holds no device time")
    evs.sort(key=lambda e: -e.self_device_time_total)
    n_prof = FRONTEND_PROFILE_FRAMES

    # two more frames, each stage under its own trace and op counter
    eng.timing = counts = _StageCounts()
    n_counted = 2
    for f in range(first + n_prof, first + n_prof + n_counted):
        eng._frame_step(seq["depth"][f], seq["color"][f], f % sub_len, eng._store_slot(f))
    per_stage = {k: {name: v / n_counted for name, v in tot.items()}
                 for k, tot in sorted(counts.totals.items())}
    del eng
    torch.cuda.empty_cache()

    return {
        "frames": n_frames,
        "all_valid": True,
        "ate_rmse_m": ate,
        "ate_rmse_m_second_run": ate_b,
        "render_median_abs_err_m": med_err,
        "alloc_failures": fails,
        "launches": launches,
        "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_max": max(frame_ms[1:]),
        "frame_ms_median_with_stage_syncs": statistics.median(frame_ms_b),
        "stage_ms_median": stage_ms,
        "stage_host_ms_median": host_ms,
        "keys_per_frame_mean": float(keys.mean()),
        "keys_per_frame_min": int(keys.min()),
        **stats,
        "live_corrs_last_window": live_corrs,
        "live_blocks": live_blocks,
        "peak_mem_gb": peak_gb,
        "frame_step_profile": {
            "frames": n_prof,
            "first_frame": first,
            "cuda_kernels_per_frame": sum(e.count for e in evs) / n_prof,
            "dispatched_ops_per_frame": sum(v["dispatched_ops"] for v in per_stage.values()),
            "wall_ms_per_frame": wall_ms / n_prof,
            "device_ms_per_frame": device_ms / n_prof,
            "device_busy_share": device_ms / wall_ms,
            "top_device_ms_per_frame": [[e.key[:80], e.self_device_time_total / 1e3 / n_prof,
                                         e.count / n_prof] for e in evs[:10]],
            "per_stage": per_stage,
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
            checker = _CheckedApply(eng)
            eng._apply_tsdf_ops = checker
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

    dev = torch.device("cuda")
    gpu = _gpu_line()
    build_s = phase_build()
    t0 = time.perf_counter()
    seq = make_sequence_wire(N_FRAMES, intr=default_intrinsics(640, 480), device=dev)
    seq_s = time.perf_counter() - t0
    gt = orbit_trajectory(N_FRAMES)
    noisy = orbit_trajectory(N_FRAMES, noise=0.01)

    app = AppConfig()
    kern = phase_kernels(dev, seq, noisy, gt, app)
    sl = phase_slice(dev, seq, noisy, gt, app)
    prof = phase_profile(dev, seq, noisy, gt, app)
    t0 = time.perf_counter()
    fe = phase_frontend(dev, seq, gt, app)
    fe["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    en = phase_engine(dev, seq, gt, app)
    en["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    en["solver_at_width"] = phase_solver_width(dev)
    en["solver_at_width"]["phase_s"] = time.perf_counter() - t0
    main_errs = [c["max_abs_err"] for c in sl["main_path_checks"].values()]
    main_errs += [c["max_abs_err"] for c in en["main_path_checks"].values()]

    def entry(name, sub, extra_err=()):
        k11 = kern["11op"][sub] if sub else kern["11op"]
        k1 = kern["1op"][sub] if sub else kern["1op"]
        e = {
            "name": name,
            "route": "cuda",
            "source": f"bundlefusion_tpu_torch/kernels/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sl["launches"][name],
            "launches_frontend": fe["launches"][name],
            "launches_engine": en["launches"][name],
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

    kernels_line = {"kernels": [
        entry("tsdf_prepare", "prepare"),
        entry("tsdf_cull", "cull"),
        {**entry("tsdf_apply", None, main_errs), "live_rows": kern["11op"]["live_rows"],
         "wave_ctas": kern["wave_ctas"]},
    ]}
    sl["profile"] = prof
    sl["build_s"] = build_s
    sl["sequence_render_s"] = seq_s
    print(gpu)
    print(json.dumps(kernels_line))
    print(json.dumps({"slice": sl}))
    print(json.dumps({"frontend": fe}))
    print(json.dumps({"engine": en}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
