"""Per-stage frame cost by ablation.

Counterpart of ``scripts/ablate.py``: the same timed loop run five times on
fresh engines, each with a stage switched off after ``warmup``, and the
differences read as the stages' share of a frame:

- ``full``: as a user runs it;
- ``no_render``: ``render_every = 0``;
- ``no_tsdf``: ``AppConfig.integration_enabled`` off (no TSDF dispatch);
- ``no_solve``: ``_dispatch_submap`` replaced by a stub that dispatches no
  boundary;
- ``frontend_only``: all three off.

On the card: 640x480, 72 frames (12 untimed), 131 072 blocks, 16 384
global correspondences, 64 keyframes, the synthetic orbit. With ``--device
cpu``: the small configuration, 13 frames (5 untimed). Writes
``<out>/ablate.json``: per configuration frames/s, ms per frame and
re-integration counts, ``attribution_ms`` (full minus each ablation; the
frontend floor) and ``_meta`` (platform, the full run, the boundaries each
configuration dispatched).

Usage:
  python -m bundlefusion_tpu_torch.scripts.ablate [config ...] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import dataclasses
import json

from bundlefusion_tpu_torch.scripts import common, seq_cache

CONFIGS = ("full", "no_render", "no_tsdf", "no_solve", "frontend_only")


def run_config(name, seq, n_frames, warmup_frames, make_engine):
    """One configuration on a fresh engine: every frame uploaded before
    ``warmup``, the switches set after it, ``warmup_frames`` untimed."""
    eng = make_engine()
    handles = [(eng.upload_frame(seq["depth"][i], seq["color"][i]),) for i in range(n_frames)]
    eng.warmup()
    if name in ("no_tsdf", "frontend_only"):
        eng.app = dataclasses.replace(eng.app, integration_enabled=False)
    if name in ("no_render", "frontend_only"):
        eng.render_every = 0
    if name in ("no_solve", "frontend_only"):
        eng._dispatch_submap = lambda last_world_dev: False

    run = common.drive(eng, handles, untimed=warmup_frames)
    res = {"fps": run["fps"], "ms_per_frame": run["ms_per_frame"],
           "reint_frames": eng.reint_frames, "reint_ops": eng.reint_ops_total}
    return res, eng.num_keyframes


def main(argv=None) -> dict:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("configs", nargs="*", help=f"any of {', '.join(CONFIGS)} (default: all)")
    p.add_argument("--cache", default=None, help="sequence cache directory")
    a = p.parse_args(argv)
    if set(a.configs) - set(CONFIGS):
        p.error(f"unknown configurations {sorted(set(a.configs) - set(CONFIGS))}")
    dev = common.resolve_device(a.device)
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
    from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, make_sequence
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    if dev.type == "cuda":
        n_frames, warm, G = 72, 12, 64
        intr = default_intrinsics(640, 480)
        app = AppConfig(hash_num_sdf_blocks=131072, hash_key_capacity=131072,
                        visible_blocks_cap=8192)
        bundling = BundlingConfig(max_global_corr=16384)
        sift_cfg = common.card_sift(app, bundling)
        seq = seq_cache.cached(n_frames, intr.width, intr.height, device=dev,
                               cache_dir=a.cache)
    else:
        n_frames, warm, G = 13, 5, 8
        intr, app, bundling, sift_cfg = common.small_config()
        seq = make_sequence(n_frames, intr=intr)

    def make_engine():
        return BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=G, device=dev)

    out, boundaries = {}, {}
    for name in a.configs or CONFIGS:
        out[name], boundaries[name] = run_config(name, seq, n_frames, warm, make_engine)
        print(name, out[name], flush=True)

    if "full" in out:
        full = out["full"]["ms_per_frame"]
        attr = {}
        for k in ("no_render", "no_tsdf", "no_solve"):
            if k in out:
                attr[k.replace("no_", "")] = full - out[k]["ms_per_frame"]
        if "frontend_only" in out:
            attr["frontend_floor"] = out["frontend_only"]["ms_per_frame"]
        out["attribution_ms"] = attr
    out["_meta"] = {"platform": common.platform(dev), "ms_full": out.get("full"),
                    "boundaries": boundaries}
    common.write_json(a.out, "ablate.json", out)
    print(json.dumps(out.get("attribution_ms", {})), flush=True)
    return out


if __name__ == "__main__":
    main()
