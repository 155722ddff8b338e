"""A long run at the engine's default capacity.

Counterpart of ``scripts/scale_run.py``: ``AppConfig()`` / ``BundlingConfig()``
defaults (G = 1200 keyframes, a 12 000-frame archive, 262 144 global
correspondences, a 16 384-pair solver cap), 640x480 input, over 1 010 frames
of the out-and-back ``loop`` trajectory with 0.2 % depth noise. Every frame
is uploaded before ``warmup``; 12 frames run untimed, the rest are timed;
then ``finish(extra_solves=2)`` and the ATE. Shows that the default-capacity
state allocates and runs and that the solver's pair cap is not hit
(``pairs_dropped`` 0). Writes ``<out>/scale_run.json``.

With ``--device cpu`` it runs the small configuration with 16 keyframes
(24 frames by default).

Usage:
  python -m bundlefusion_tpu_torch.scripts.scale_run [n_frames] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import json

from bundlefusion_tpu_torch.scripts import common, seq_cache
from bundlefusion_tpu_torch.scripts.drift_demo import engine_health

WARMUP_FRAMES = 12


def main(argv=None) -> dict:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("n_frames", type=int, nargs="?", default=None)
    p.add_argument("--cache", default=None, help="sequence cache directory")
    a = p.parse_args(argv)
    dev = common.resolve_device(a.device)
    small = dev.type != "cuda"
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
    from bundlefusion_tpu_torch.io.synthetic import default_intrinsics
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse

    if small:
        n_frames = a.n_frames or 24
        intr, app, bundling, sift_cfg = common.small_config()
        max_keyframes = 16
    else:
        n_frames = a.n_frames or 1010
        intr = default_intrinsics(640, 480)
        app, bundling = AppConfig(), BundlingConfig()
        sift_cfg = common.card_sift(app, bundling)
        max_keyframes = None
    print(f"rendering {n_frames}-frame loop sequence (cached) ...", flush=True)
    seq = seq_cache.cached(n_frames, intr.width, intr.height, traj="loop", noise=0.002,
                           device=dev, cache_dir=a.cache)

    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=max_keyframes,
                       device=dev)
    if not small and not (eng.G == 1200 and eng.frame_cap >= 12000):
        raise AssertionError(f"not the default capacity: G {eng.G}, archive {eng.frame_cap}")
    handles = [(eng.upload_frame(seq["depth"][i], seq["color"][i]),) for i in range(n_frames)]
    common.sync(dev)
    t_compile = eng.warmup()
    print(f"compile_s={t_compile:.1f}", flush=True)

    def progress(done, t0):
        if (done - 1) % 100 == 0:
            print(f"  frame {done - 1}/{n_frames} kf={eng.num_keyframes}", flush=True)

    run = common.drive(eng, handles, untimed=min(WARMUP_FRAMES, n_frames - 1),
                       extra_solves=2, progress=progress)
    traj = eng.trajectory()
    rmse, n_valid = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])
    health = engine_health(eng)

    out = {
        "platform": common.platform(dev),
        "frames": n_frames,
        "keyframes": eng.num_keyframes,
        "keyframe_capacity": eng.G,
        "frame_archive_capacity": eng.frame_cap,
        "fps": run["fps"],
        "ms_per_frame": run["ms_per_frame"],
        "ate_rmse_cm": rmse * 100,
        "valid_frames": int(n_valid),
        "pairs_dropped": eng.pairs_dropped_total,
        "lost_count": eng.lost_count,
        "compile_s": t_compile,
        "reint_frames": eng.reint_frames,
        "reint_ops": eng.reint_ops_total,
        "corr_count": int(eng.glob.corrs.count),
        "corr_capacity": eng.glob.corrs.capacity,
        "stage_ms": {k: 1000.0 * v for k, v in eng.timing.averages().items()
                     if k.startswith("time_")},
        "finish_s": run["finish_s"],
        "invariants": health["invariants"],
        "alloc_failures": health["alloc_failures"],
        "host_reads_per_boundary": health["host_reads_per_boundary"],
        "prune_rounds_per_boundary": health["prune_rounds_per_boundary"],
        "live_rows": health["live_rows"],
        "peak_mem_gb": run["peak_mem_gb"],
    }
    common.write_json(a.out, "scale_run.json", out)
    print(json.dumps(out), flush=True)
    if out["pairs_dropped"] != 0:
        raise AssertionError("the solver's pair cap overflowed at capacity")
    return out


if __name__ == "__main__":
    main()
