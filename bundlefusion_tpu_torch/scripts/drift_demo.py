"""Drift correction and relocalization on a hard sequence.

Counterpart of ``scripts/drift_demo.py``: an out-and-back excursion that
returns to its start (a real loop closure), multiplicative depth noise of
0.5 %, and a blackout one submap long 60 % of the way through (empty frames
that force a tracking loss). Reports the ATE of the chained (odometry only)
and of the optimized trajectory, lost keyframes, invalid frames and the
frames valid again after the blackout, into ``<out>/drift_demo.json``.

On the card: 640x480, 241 frames, 64 keyframes, 131 072 blocks, 32 768
global correspondences. With ``--device cpu``: the small configuration of
the JAX script's CPU branch, at most 41 frames. Besides the JAX script's
keys the result holds what the port's engine counts: revalidations
attempted and won, prune rounds and host reads per boundary,
re-integration, live rows, table invariants, allocation failures and peak
device memory.

Usage:
  python -m bundlefusion_tpu_torch.scripts.drift_demo [n_frames] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import json

import numpy as np

from bundlefusion_tpu_torch.scripts import common

NOISE = 0.005


def configs(small: bool):
    """(intr, app, bundling, sift_cfg, max_keyframes) of the demo."""
    if small:
        return (*common.small_config(), 12)
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig
    from bundlefusion_tpu_torch.io.synthetic import default_intrinsics

    app = AppConfig(hash_num_sdf_blocks=131072, hash_key_capacity=131072,
                    visible_blocks_cap=8192)
    bundling = BundlingConfig(max_global_corr=32768)
    return default_intrinsics(640, 480), app, bundling, common.card_sift(app, bundling), 64


def blackout_of(n_frames: int, sub_len: int):
    """One submap long, about 60 % of the way through."""
    b0 = (int(n_frames * 0.6) // sub_len) * sub_len + 2
    return b0, b0 + sub_len


class RevalidationLog:
    """Wraps an engine's ``_try_revalidation``: attempts, and the attempts
    that brought their keyframe back."""

    def __init__(self, eng):
        self.eng, self.inner = eng, eng._try_revalidation
        self.attempted = self.succeeded = 0
        eng._try_revalidation = self

    def __call__(self):
        eng = self.eng
        k = eng.retry_list[0] if eng.retry_list else None
        self.inner()
        if k is not None:
            self.attempted += 1
            self.succeeded += int(bool(eng.keyframe_valid[k]))


def ate_pair(eng, gt):
    """(chained ATE, optimized ATE, validity) of a finished engine; the
    chained trajectory is scored over the frames the engine kept valid."""
    from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse

    optimized = eng.trajectory()
    valid = common.validity(optimized)
    chained = np.stack(eng.sift_world)[: len(valid)]
    ate_c, _ = evaluate_ate_rmse(np.where(valid[:, None, None], chained, np.nan),
                                 gt[: len(valid)])
    ate_o, _ = evaluate_ate_rmse(optimized, gt[: len(optimized)])
    return ate_c, ate_o, valid


def engine_health(eng) -> dict:
    """What the port's engine counts that the JAX script does not print."""
    from bundlefusion_tpu_torch.tsdf.table import EMPTY_KEY, check_invariants

    return {
        "invariants": {k: int(v) for k, v in check_invariants(eng.table).items()},
        "alloc_failures": int(eng.table.num_alloc_failures),
        "reint_frames": eng.reint_frames,
        "reint_ops": eng.reint_ops_total,
        "pairs_dropped": eng.pairs_dropped_total,
        "prune_rounds_per_boundary": [s["prune_rounds"] for s in eng.boundary_stats],
        "host_reads_per_boundary": [s["host_reads"] for s in eng.boundary_stats],
        "live_rows": int((eng.table.slot_keys[:-1] != EMPTY_KEY).sum()),
        "global_live_corrs": int(eng.glob.corrs.valid_mask().sum()),
    }


def run(seq, intr, app, bundling, sift_cfg, G, dev, blackout, hook=None):
    """The demo on ``seq`` (wire frames, true poses). ``hook(eng)`` runs
    after ``warmup`` and before the first frame. Returns (result, engine)."""
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    sub_len = bundling.submap_size
    n_frames = seq["depth"].shape[0]
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=G, device=dev)
    t_compile = eng.warmup()
    reval = RevalidationLog(eng)
    if hook is not None:
        hook(eng)
    stats = common.drive(eng, [(seq["depth"][i], seq["color"][i]) for i in range(n_frames)],
                         extra_solves=3)

    ate_c, ate_o, valid = ate_pair(eng, seq["poses"])
    after = np.arange(len(valid)) >= blackout[1] + sub_len
    recovered, after_total = int((valid & after).sum()), int(after.sum())
    out = {
        "platform": common.platform(dev),
        "frames": n_frames,
        "keyframes": eng.num_keyframes,
        "fps": stats["fps"],
        "blackout": list(blackout),
        "ate_chained_cm": float(ate_c) * 100,
        "ate_optimized_cm": float(ate_o) * 100,
        "improvement_x": float(ate_c / max(ate_o, 1e-9)),
        "valid_frames": int(valid.sum()),
        "invalid_frames": int((~valid).sum()),
        "lost_keyframes": eng.lost_count,
        "recovered_frames_after_blackout": [recovered, after_total],
        "compile_s": t_compile,
        "revalidations": {"attempted": reval.attempted, "succeeded": reval.succeeded},
        **engine_health(eng),
        "peak_mem_gb": stats["peak_mem_gb"],
    }
    return out, eng


def check(out: dict, sub_len: int) -> None:
    """The demo's contract (``scripts/drift_demo.py:145-146``): the engine
    lost tracking in the blackout and recovered it after."""
    recovered, after_total = out["recovered_frames_after_blackout"]
    if not (out["lost_keyframes"] >= 1 or out["invalid_frames"] >= sub_len):
        raise AssertionError(f"no tracking loss in the blackout: {out}")
    if not recovered > after_total * 0.7:
        raise AssertionError(f"tracking not recovered: {recovered} of {after_total}")


def main(argv=None, hook=None) -> dict:
    """``hook(eng)``, when given, runs after ``warmup`` (a caller's probe
    of the engine)."""
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("n_frames", type=int, nargs="?", default=241)
    a = p.parse_args(argv)
    dev = common.resolve_device(a.device)
    small = dev.type != "cuda"
    n_frames = min(a.n_frames, 41) if small else a.n_frames
    intr, app, bundling, sift_cfg, G = configs(small)
    blackout = blackout_of(n_frames, bundling.submap_size)
    from bundlefusion_tpu_torch.io.synthetic import loop_trajectory, make_sequence_wire

    print(f"rendering {n_frames} frames (blackout {blackout}) ...", flush=True)
    seq = make_sequence_wire(n_frames, intr=intr, poses=loop_trajectory(n_frames),
                             noise_depth=NOISE, blackout=blackout, device=dev)
    out, _ = run(seq, intr, app, bundling, sift_cfg, G, dev, blackout, hook=hook)
    common.write_json(a.out, "drift_demo.json", out)
    print(json.dumps(out), flush=True)
    check(out, bundling.submap_size)
    return out


if __name__ == "__main__":
    main()
