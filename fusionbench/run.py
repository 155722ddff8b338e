"""One run of one cell of the benchmark of ``bundlefusion_tpu_torch``.

    python -m fusionbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/``, its traffic in
``traffic/<traffic>.json``, its comparison's limits in
``limits/<cell>.json``, and each metric's reader in ``metrics/<name>.py``.

A run: build the kernels; render the cell's seeded scan on the card (nothing
is written to disk); construct the engine and ``warmup()``; feed the
traffic's untimed frames; measure for ``--seconds`` (``setup_s`` is the
time from the process's start to here); then, off the clock, with
``--trace 1`` the engine's serialized replay of a few more frames;
``finish(extra_solves=2)`` and ``trajectory()``; read the peak memory and
the outputs, free the engine, and hold the outputs against the plain
reference (``check.py``). The last line of standard output is the result's
JSON; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from two profiler stretches inside
the window (``trace.py``), the replay, the benchmark's own spans and the
program's span records and counters over the window (``rec["program"]``).

The run refuses (exit 2, no result) without a CUDA card or with fewer cards
than the cell asks for, and (exit 3) when a module of JAX or of the JAX
package has been loaded.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bundlefusion_tpu")
COMPLETION_WAIT_S = 120.0   # how long a frame may take to complete after the window


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def named(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_spec(name: str, root: str = ROOT) -> dict:
    """Everything the cell ``name`` is made of, from its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    wl = named(bench["workloads"], name, "workload")
    cfg = named(bench["configs"], wl["config"], "config")
    config = load_json(os.path.join(root, cfg["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", wl["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))

    def reported(kind):
        return [m for m in bench[kind] if "workloads" not in m or name in m["workloads"]]

    return {"workload": wl, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": reported("end_to_end"), "per_layer": reported("per_layer")}


def load_reader(metric: str):
    """The reader module of a metric, ``metrics/<metric>.py``, or, for a
    quantity split by the cells that report it (``host_frame_ms.live``),
    the quantity's ``metrics/host_frame_ms.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(HERE, "metrics", metric.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location("fusionbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_config(config: dict) -> dict:
    """The configuration file's values, plus what the reference takes from
    them: the TSDF's parameters and the integration size."""
    app = config["app"]
    return {**config,
            "tsdf": {"voxel_size": app["sdf_voxel_size"], "truncation": app["sdf_truncation"],
                     "truncation_scale": app["sdf_truncation_scale"],
                     "max_integration_distance": app["sdf_max_integration_distance"],
                     "depth_min": app["sensor_depth_min"], "depth_max": app["sensor_depth_max"]},
            "integration_size": (app["integration_width"], app["integration_height"])}


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def frames_to_render(traffic: dict, seconds: float, trace: bool) -> int:
    """An open loop renders exactly the frames it offers; a closed loop the
    whole scan, which it replays cyclically."""
    if traffic["loop"] == "open":
        n = traffic["warm_frames"] + window_frames(traffic, seconds)
        return n + (traffic["trace"]["replay_frames"] if trace else 0)
    return traffic["scan"]["frames"]


def window_frames(traffic: dict, seconds: float) -> int:
    return int(round(traffic["rate_hz"] * seconds))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_block(dev, peak) -> dict:
    import subprocess

    import torch

    from fusionbench import window

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    try:
        power = window.gpu_line().rsplit(",", 1)[1].strip()
    except (OSError, subprocess.CalledProcessError, IndexError) as e:
        power = f"not read: {e}"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": peak, "power_limit": power}


def finite_or_none(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def host_calls(spans, bounds) -> str:
    """The window's host time per call, frames apart from boundaries."""
    parts = []
    for what, pick in (("frame", False), ("boundary", True)):
        ms = sorted(1e3 * (e - s) for (s, e), b in zip(spans, bounds) if b == pick)
        if ms:
            parts.append(f"{len(ms)} {what} calls {sum(ms) / len(ms):.3f} ms mean, "
                         f"{ms[len(ms) // 2]:.3f} median, {ms[-1]:.3f} max")
    return "; ".join(parts)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: str = ROOT, overrides: dict | None = None, system_cls=None) -> dict:
    """One run; returns the result's dict (see the module docstring).
    ``overrides`` deep-merges into the cell's configuration (``config``),
    traffic (``traffic``) and limits (``limits``): for rehearsals at a small
    size. ``system_cls`` replaces the system under test (``system.System``)."""
    import numpy as np
    import torch

    from fusionbench import check, reference, scan, trace as tr, window
    from fusionbench.system import System

    system_cls = system_cls or System
    spec = cell_spec(name, root)
    over = overrides or {}
    config = run_config(merge(spec["config"], over.get("config", {})))
    traffic = merge(spec["traffic"], over.get("traffic", {}))
    limits = merge(spec["limits"], over.get("limits", {}))
    dev = torch.device(device)
    window.reset_peak(dev)

    t = time.perf_counter()
    system_cls.build_kernels(dev)
    log(f"fusionbench: kernels built in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    n_render = frames_to_render(traffic, seconds, trace)
    frames = scan.make_scan(traffic, config["camera"], seed, n_render, dev)
    log(f"fusionbench: {n_render} frames rendered in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    sut = system_cls(config, dev)
    sut.warmup()
    log(f"fusionbench: engine built and warmed up in {time.perf_counter() - t:.3f} s")

    fed = []   # the generated frame each fed frame was

    def offer(k: int):
        i = k % n_render
        fed.append(i)
        if not trace:
            return sut.process(sut.upload(frames["depth"][i], frames["color"][i]))
        what = "boundary_frame" if sut.is_boundary(k) else "frame"
        with torch.profiler.record_function(tr.ANNOTATION + what):
            return sut.process(sut.upload(frames["depth"][i], frames["color"][i]))

    def sensor_wait(s: float) -> None:
        with torch.profiler.record_function(tr.ANNOTATION + "sensor_wait"):
            time.sleep(s)

    warm = traffic["warm_frames"]
    for k in range(warm):
        offer(k).synchronize()
    sut.sync()
    setup_s = time.perf_counter() - t_start
    log(f"fusionbench: set-up {setup_s:.3f} s; window of {seconds} s")

    # ---- the window ----
    stretches = {}
    if trace:
        plan = {"device": (tr.Stretch(host=False), *traffic["trace"]["device_stretch"]),
                "gaps": (tr.Stretch(host=True), *traffic["trace"]["gap_stretch"])}
    else:
        plan = {}
    open_ = {}

    def on_frame(k: int) -> None:
        for key, (st, first, count) in plan.items():
            if k == first:
                if key == "gaps":   # the program's spans as profiler ranges here alone
                    sut.trace(True, profiler_ranges=True)
                st.start()
                open_[key] = st
            elif k == first + count and key in open_:
                st.frames = count
                st.stop(sut.sync)
                stretches[key] = open_.pop(key)
                if key == "gaps":
                    sut.trace(True)

    reint0 = sut.reint_frames
    kf_open = sut.keyframes
    if trace:
        sut.trace(True)
    comp = window.Completions()
    first = warm
    if traffic["loop"] == "open":
        n_win = window_frames(traffic, seconds)
        res = window.open_loop(lambda k: offer(first + k), n_win, traffic["rate_hz"], comp,
                               sleep=sensor_wait if trace else time.sleep, on_frame=on_frame)
        done = comp.close(COMPLETION_WAIT_S + seconds)
        win = window.live_metrics(res["due"], done)
        offered = n_win
    else:
        res = window.closed_loop(lambda k: offer(first + k), seconds, comp, on_frame=on_frame)
        done = comp.close(COMPLETION_WAIT_S)
        offered = len(res["spans"])
        win = window.offline_metrics(res["t0"], res["t_end"], offered, done)
    for key, st in list(open_.items()):   # a stretch the window cut short
        st.frames = offered - plan[key][1]
        st.stop(sut.sync)
        stretches[key] = st
    sut.sync()
    program = None
    if trace:
        sut.trace(False)
        program = sut.program()
    reint_share = (sut.reint_frames - reint0) / max(offered, 1)
    bounds = [sut.is_boundary(first + k) for k in range(offered)]
    state = {"keyframes_at_open": kf_open, **sut.state(since=kf_open)}
    log(f"fusionbench: window closed: {offered} frames offered, "
        f"{offered - win['not_completed']} completed; {host_calls(res['spans'], bounds)}; "
        + (f"latency p50 {win['frame_ms_p50']:.3f} ms, p95 {win['frame_ms_p95']:.3f} ms; "
           if "frame_ms_p95" in win else "")
        + ", ".join(f"{k} {v}" for k, v in state.items()))

    # ---- off the clock: the replay, finish, the outputs ----
    replay = None
    if trace:
        n_rep = traffic["trace"]["replay_frames"]
        base = len(fed)
        totals0 = sut.stage_totals()
        sut.replay(True)
        try:
            for k in range(n_rep):
                offer(base + k).synchronize()
        finally:
            sut.replay(False)
        totals1 = sut.stage_totals()
        replay = {"device_ms": sut.device_ms(),
                  "stage_s": {k: v - totals0.get(k, 0.0) for k, v in totals1.items()},
                  "boundaries": sum(sut.is_boundary(base + k) for k in range(n_rep))}
    render_pose = sut.last_pose()
    sut.finish()
    traj = sut.trajectory()
    render = sut.last_render()
    map_sample = sut.map_sample(limits["map_samples"], seed, config["tsdf"]["voxel_size"])
    peak = window.peak_bytes(dev)
    dev_info = device_block(dev, peak)
    sut.close()
    del sut

    bad = forbidden_modules()
    if bad:
        log(f"fusionbench: refused: modules of JAX or of the JAX package are loaded: {bad}")
        raise SystemExit(3)

    idx = np.asarray(fed)
    truth = np.asarray(frames["poses"], np.float64)[idx]
    truth_rel = reference.relative_poses(truth)
    ate_m, _ = reference.ate_rmse(traj, truth_rel) if len(traj) == len(idx) else (math.inf, 0)
    win_traj = np.asarray(traj)[warm:warm + offered] if len(traj) else np.zeros((0, 4, 4))
    invalid = int(offered - np.isfinite(win_traj).all((1, 2)).sum())
    outputs = {"trajectory": traj, "scan_index": idx, "map": map_sample,
               "render": {"depth": render, "pose": render_pose}}
    t = time.perf_counter()
    numbers = check.compare(outputs, frames, config, dev, traffic["scan"].get("scene"))
    if traffic["scan"]["trajectory"] == "walk":
        numbers["leg_gap_cm"] = check.leg_gap_cm(traj, truth_rel, idx, traffic["scan"]["frames"])
    correct, checks = check.verdict(numbers, limits)
    log(f"fusionbench: reference compared in {time.perf_counter() - t:.3f} s "
        f"({numbers['map_compared']} voxels of {numbers['map_samples']} sampled)")

    rec = {"setup_s": setup_s, "window": win, "ate_cm": 100.0 * ate_m, "spans": res["spans"],
           "boundary": bounds, "reint_share": reint_share, "replay": replay, "state": state,
           "profile": {k: tr.device_summary(v) for k, v in stretches.items()},
           "loop": traffic["loop"]}
    if trace:
        rec["program"] = program
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec[kind]:
        v = load_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": offered,
              "failed": int(win["not_completed"]) + invalid, "metrics": metrics,
              "device": dev_info}
    if trace:
        dsum = rec["profile"].get("device", {})
        if dsum:
            dev_info["busy_s"] = dsum["busy_s"]
            dev_info["window_s"] = dsum["window_s"]
        gaps = tr.idle_gaps(stretches["gaps"]) if "gaps" in stretches else []
        result["breakdown"] = {"device_ops": dsum.get("device_ops", []), "idle_gaps": gaps}
    result["checks"] = {k: {"value": finite_or_none(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    log("fusionbench: readings not compared: " + ", ".join(
        f"{k} {numbers[k]}" for k in ("pose_err_max_cm", "map_sdf_p50_mm", "map_sdf_p95_mm",
                                      "map_unseen_share", "leg_gap_cm") + check.NUMBERS
        if k in numbers and k not in checks))
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    chips = cell_spec(a.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"fusionbench: the cell needs {chips} CUDA card(s) and {n} are available")
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    print(json.dumps(result), flush=True)
    return 0
