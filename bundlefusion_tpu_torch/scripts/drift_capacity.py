"""Drift correction and relocalization at keyframe capacity.

Counterpart of ``scripts/drift_capacity.py``: 6 400 frames by default
(640 keyframes at submaps of 10) of a trajectory with three loop closures
(``multiloop``), 0.5 % depth noise and two tracking blackouts one submap long,
at 35 % and 70 % of the way. 320x240 input, SIFT and integration; 131 072
blocks; a correspondence store of 1<<23 rows, a pair budget of 262 144 and a
working set of 1<<22 rows, so the loop-dense pair graph drops nothing. The
sequence is rendered in shards of 400 frames (``seq_cache``; a shard takes
the first blackout that falls into it), every frame is uploaded before
``warmup``, and a progress line is printed per shard (also written to
``<out>/drift_capacity.progress.json``). Then ``finish(extra_solves=3)``.

Reports the JAX script's keys (chained and optimized ATE, lost keyframes,
recovery after the blackouts, re-integration, dropped pairs, table
invariants) and what the port counts besides: per boundary its ms, host
reads and prune rounds, the presort's ms against g, launches and device ms
of the boundaries at g = 10, 100, 600 and the last one (a trace of the card
around each), and peak device memory. With ``--device cpu`` it runs the
small configuration with an 80x60 dense cache (submaps of 4; 123 frames
by default, three loops of the drift demo's 41) and takes no time on the
card.

Usage:
  python -m bundlefusion_tpu_torch.scripts.drift_capacity [n_frames] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import json
import time

import numpy as np

from bundlefusion_tpu_torch.scripts import common, seq_cache
from bundlefusion_tpu_torch.scripts.drift_demo import RevalidationLog, ate_pair, engine_health

NOISE = 0.005
PROBE_G = (10, 100, 600)
# the CPU run: three loops of 41 frames, the drift demo's loop length there
CPU_FRAMES = 123


def configs(small: bool):
    """(intr, app, bundling, sift_cfg) of the run."""
    if small:
        # an 80x60 dense cache: at the small configuration's 40x30 a correct
        # submap leaves a verify error around the 0.075 threshold, and the
        # multiloop's first submaps fail it (ROADMAP Queue 3)
        return common.small_config(downsampled_width=80, downsampled_height=60,
                                   max_global_corr=1 << 14)
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
    from bundlefusion_tpu_torch.io.synthetic import default_intrinsics

    w, h = 320, 240
    app = AppConfig(integration_width=w, integration_height=h,
                    hash_num_sdf_blocks=131072, hash_key_capacity=131072,
                    visible_blocks_cap=8192)
    bundling = BundlingConfig(width_sift=w, height_sift=h, max_global_corr=1 << 23,
                              solver_max_pairs=262144, solver_max_working_corrs=1 << 22)
    return default_intrinsics(w, h), app, bundling, common.card_sift(app, bundling, min_scale=1.5)


def blackouts_of(n_frames: int, sub: int):
    b0 = (int(n_frames * 0.35) // sub) * sub + 2
    b1 = (int(n_frames * 0.7) // sub) * sub + 2
    return [(b0, b0 + sub), (b1, b1 + sub)]


def shard_blackout(blackouts, s0: int, n: int):
    """The first blackout that falls into shard [s0, s0 + n), or None."""
    for b0, b1 in blackouts:
        if b0 < s0 + n and b1 > s0:
            return (b0, b1)
    return None


class BoundaryProbe:
    """Times every boundary of an engine (host clock between two waits for
    the device) and its presort, and traces the card around the boundaries
    in ``probe_g``: CUDA launches and their device ms."""

    def __init__(self, eng, dev, probe_g):
        from bundlefusion_tpu_torch.pipeline import online

        self.eng, self.dev, self.probe_g = eng, dev, set(probe_g)
        self.boundary_ms, self.presort_ms, self.traced = [], [], {}
        self._online = online
        self._presort = online.presort_corrs
        self._step = eng._submap_step
        online.presort_corrs = self._timed_presort
        eng._submap_step = self._timed_step

    def close(self):
        self._online.presort_corrs = self._presort
        self.eng._submap_step = self._step

    def _timed_presort(self, *args, **kw):
        ms, out = common.wall_ms(self.dev, lambda: self._presort(*args, **kw))
        self.presort_ms.append([len(self.boundary_ms), ms])
        return out

    def _timed_step(self, g, last_world):
        if g in self.probe_g and self.dev.type == "cuda":
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ms, pack = common.wall_ms(self.dev, lambda: self._step(g, last_world))
            evs = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            self.traced[g] = {"launches": sum(e.count for e in evs),
                              "device_ms": sum(e.self_device_time_total for e in evs) / 1e3,
                              "ms_traced": ms}
        else:
            ms, pack = common.wall_ms(self.dev, lambda: self._step(g, last_world))
        self.boundary_ms.append(ms)
        return pack

    def summary(self) -> dict:
        stats = self.eng.boundary_stats
        at = {}
        for g, tr in sorted(self.traced.items()):
            at[str(g)] = {**tr, "host_reads": stats[g]["host_reads"],
                          "prune_rounds": stats[g]["prune_rounds"]}
        return {"boundary_ms": self.boundary_ms,
                "presort_ms_by_g": self.presort_ms,
                "host_reads_by_g": [s["host_reads"] for s in stats],
                "prune_rounds_by_g": [s["prune_rounds"] for s in stats],
                "traced_boundaries": at}


def main(argv=None) -> dict:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("n_frames", type=int, nargs="?", default=None)
    p.add_argument("--cache", default=None, help="sequence cache directory")
    a = p.parse_args(argv)
    dev = common.resolve_device(a.device)
    small = dev.type != "cuda"
    n_frames = a.n_frames or (CPU_FRAMES if small else 6400)
    intr, app, bundling, sift_cfg = configs(small)
    sub = bundling.submap_size
    G = n_frames // sub
    blackouts = blackouts_of(n_frames, sub)
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=G, device=dev)
    # every frame on the device before the first engine program runs
    t0 = time.perf_counter()
    gt, handles = [], []
    for s0, n in seq_cache.shards(n_frames):
        data = seq_cache.cached(n, intr.width, intr.height, "multiloop", NOISE,
                                shard_blackout(blackouts, s0, n), start=s0, full_n=n_frames,
                                device=dev, cache_dir=a.cache)
        gt.append(data["poses"])
        handles += [(eng.upload_frame(data["depth"][i], data["color"][i]),) for i in range(n)]
    common.sync(dev)
    prestage_s = time.perf_counter() - t0
    print(f"prestage_s={prestage_s:.1f}", flush=True)
    t_compile = eng.warmup()
    print(f"compile_s={t_compile:.1f}", flush=True)

    reval = RevalidationLog(eng)
    probe = BoundaryProbe(eng, dev, [g for g in (*PROBE_G, G - 1) if 0 < g < G])
    shard_ends = {s0 + n for s0, n in seq_cache.shards(n_frames)}

    def progress(done, t0):
        if done not in shard_ends:
            return
        common.sync(dev)
        el = time.perf_counter() - t0
        prog = {"frames": done, "of": n_frames, "elapsed_s": el, "fps": done / el,
                "keyframes": eng.num_keyframes, "lost": eng.lost_count,
                "reint_ops": eng.reint_ops_total,
                "live_corrs": int(eng.glob.corrs.valid_mask().sum()),
                "peak_mem_gb": common.peak_mem_gb(dev)}
        common.write_json(a.out, "drift_capacity.progress.json", prog)
        print(json.dumps(prog), flush=True)

    try:
        run = common.drive(eng, handles, extra_solves=3, progress=progress)
    finally:
        probe.close()

    gt = np.concatenate(gt)
    ate_c, ate_o, valid = ate_pair(eng, gt)
    after = np.arange(len(valid)) >= blackouts[-1][1] + sub
    recovered, after_total = int((valid & after).sum()), int(after.sum())
    health = engine_health(eng)
    kv = np.asarray(eng.keyframe_valid[: eng.num_keyframes])
    lv = eng.glob.local_valid[: eng.num_keyframes].cpu().numpy()
    invalid = np.where(~valid)[0]
    corr_count, corr_capacity = int(eng.glob.corrs.count), eng.glob.corrs.capacity
    out = {
        "corr_count": corr_count,
        "corr_capacity": corr_capacity,
        "corr_store_full": corr_count >= corr_capacity,
        "kf_valid": int(kv.sum()),
        "kf_invalid_idx_head": [int(x) for x in np.where(~kv)[0][:20]],
        "local_valid_frac": float(lv.mean()),
        "first_invalid_frame": int(invalid[0]) if len(invalid) else -1,
        "platform": common.platform(dev),
        "frames": n_frames,
        "keyframes": eng.num_keyframes,
        "keyframe_capacity": G,
        "fps": run["fps"],
        "blackouts": [list(b) for b in blackouts],
        "ate_chained_cm": float(ate_c) * 100,
        "ate_optimized_cm": float(ate_o) * 100,
        "improvement_x": float(ate_c / max(ate_o, 1e-9)),
        "valid_frames": int(valid.sum()),
        "invalid_frames": int((~valid).sum()),
        "lost_keyframes": eng.lost_count,
        "recovered_frames_after_blackouts": [recovered, after_total],
        "reint_frames": eng.reint_frames,
        "reint_ops": eng.reint_ops_total,
        "pairs_dropped": eng.pairs_dropped_total,
        "invariants": health["invariants"],
        "compile_s": t_compile,
        "prestage_s": prestage_s,
        "finish_s": run["finish_s"],
        "alloc_failures": health["alloc_failures"],
        "live_rows": health["live_rows"],
        "global_live_corrs": health["global_live_corrs"],
        "revalidations": {"attempted": reval.attempted, "succeeded": reval.succeeded},
        "peak_mem_gb": run["peak_mem_gb"],
        "boundaries": probe.summary(),
    }
    common.write_json(a.out, "drift_capacity.json", out)
    print(json.dumps({k: v for k, v in out.items() if k != "boundaries"}), flush=True)
    if any(out["invariants"].values()):
        raise AssertionError(f"table invariants {out['invariants']}")
    if not (out["improvement_x"] >= 5.0 or out["ate_optimized_cm"] <= 1.0):
        raise AssertionError(f"optimization does not beat odometry: {out}")
    return out


if __name__ == "__main__":
    main()
