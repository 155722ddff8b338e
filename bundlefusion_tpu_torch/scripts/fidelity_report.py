"""Precision and recall of each filter stage of the frontend against ground
truth on a synthetic sequence.

Counterpart of ``scripts/fidelity_report.py`` (the reference's
``CorrespondenceEvaluator`` methodology), on ``utils.corr_eval``: the
cascade (Kabsch, surface area, dense verify) over the pairs of 10 frames at
160x120 with a 40x30 dense cache, or with ``--full`` 24 frames at 640x480
with the reference's 80x60 cache. Adds the sweep of the dense-verify
thresholds over the raw per-pair scores and the Kabsch recall against the
25-per-pair cap. Writes ``<out>/fidelity_report.json`` and
``<out>/fidelity_report.csv``.

Usage:
  python -m bundlefusion_tpu_torch.scripts.fidelity_report [--full] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import json
import os

from bundlefusion_tpu_torch.scripts import common


def threshold_sweep(dense_rows) -> list:
    """Precision / recall of the pair-level verify decision at each
    (err_thresh, corr_thresh), the reference point (0.075, 0.02) among them."""
    sweep = []
    for et in (0.05, 0.075, 0.1, 0.15, 0.2):
        for ct in (0.01, 0.02, 0.05):
            ok = [r["err"] <= et and r["corr"] >= ct for r in dense_rows]
            tp = sum(1 for r, k in zip(dense_rows, ok) if r["good"] and k)
            fp = sum(1 for r, k in zip(dense_rows, ok) if not r["good"] and k)
            fn = sum(1 for r, k in zip(dense_rows, ok) if r["good"] and not k)
            sweep.append({"err_thresh": et, "corr_thresh": ct,
                          "precision": tp / max(tp + fp, 1), "recall": tp / max(tp + fn, 1),
                          "tp": tp, "fp": fp, "fn": fn})
    return sweep


def main(argv=None) -> dict:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true", help="640x480, 24 frames, 80x60 cache")
    a = p.parse_args(argv)
    dev = common.resolve_device(a.device)
    from bundlefusion_tpu_torch.config import BundlingConfig
    from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, make_sequence
    from bundlefusion_tpu_torch.ops.filters import DenseVerifyParams
    from bundlefusion_tpu_torch.ops.sift import SiftConfig
    from bundlefusion_tpu_torch.pipeline.frontend import FrontendParams
    from bundlefusion_tpu_torch.utils.corr_eval import evaluate_frontend_fidelity

    if a.full:
        intr = default_intrinsics(640, 480)
        sift = SiftConfig(target_keys=150, min_scale=3.0)
        n, cache_intr = 24, intr.scaled(80, 60)
    else:
        intr = default_intrinsics(160, 120)
        sift = SiftConfig(num_octaves=3, target_keys=96, max_candidates_per_octave=256,
                          min_scale=1.0, dog_thresh=0.004)
        n, cache_intr = 10, intr.scaled(40, 30)
    b = BundlingConfig()
    fp = FrontendParams(
        sift_match_thresh=b.sift_match_thresh,
        sift_match_ratio=b.sift_match_ratio_max_local,
        num_raw_matches=b.max_matches_per_image_pair_raw,
        max_filtered=b.max_matches_per_image_pair_filtered,
        min_num_matches=4,
        max_kabsch_res2=b.max_kabsch_residual2,
        surf_area_thresh=b.surf_area_pca_thresh,
        dense=DenseVerifyParams(),
    )
    seq = make_sequence(n, intr=intr, device=dev)
    ev, summary = evaluate_frontend_fidelity(seq, intr, sift, fp, intr_cache=cache_intr,
                                             device=dev)
    summary["_threshold_sweep"] = threshold_sweep(ev.dense_rows)
    # the filter keeps at most max_filtered matches per pair by design
    # (GlobalDefines.h:9), so raw recall counts capped-out correct matches
    # as misses; recall against the cap counts what the cap allows
    per_pair = {(r["j"], r["i"]): r for r in ev.rows if r["stage"] == "1_kabsch"}
    cap_tp = cap_fn = 0
    for r in per_pair.values():
        attainable = min(r["n_correct_in"], fp.max_filtered)
        got = min(r["n_correct_out"], attainable)
        cap_tp += got
        cap_fn += attainable - got
    if "1_kabsch" in summary:
        summary["1_kabsch"]["recall_vs_cap"] = cap_tp / max(cap_tp + cap_fn, 1)
    summary["_config"] = {
        "platform": common.platform(dev),
        "sift_w": intr.width, "sift_h": intr.height,
        "cache_w": cache_intr.width, "cache_h": cache_intr.height, "frames": n,
    }
    os.makedirs(a.out, exist_ok=True)
    ev.to_csv(os.path.join(a.out, "fidelity_report.csv"))
    common.write_json(a.out, "fidelity_report.json", summary)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
