"""The end-to-end verify drive at the small configuration.

Counterpart of ``scripts/verify_drive.py`` (the recipe of the repo's verify
notes): 9 synthetic frames at 160x120 through ``process_frame``,
``finish(extra_solves=1)``, then the checks: every frame valid, ATE RMSE
under 6 cm, table invariants clean and no allocation failure, the raycast
``render`` at frame 0 within 3 voxels of the true depth (median over more
than 1 000 hit pixels), a mesh of more than 10 000 vertices. Writes
``<out>/verify_drive.json``.

Usage:
  python -m bundlefusion_tpu_torch.scripts.verify_drive [--device cpu] [--out DIR]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from bundlefusion_tpu_torch.scripts import common

N_FRAMES = 9


def main(argv=None) -> dict:
    a = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.resolve_device(a.device)
    from bundlefusion_tpu_torch.io.synthetic import make_sequence
    from bundlefusion_tpu_torch.ops.image import resample_nearest
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.tsdf.table import check_invariants
    from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse

    intr, app, bund, sift = common.small_config()
    seq = make_sequence(N_FRAMES, intr=intr, device=dev)
    eng = BundleFusion(intr, app, bund, sift_cfg=sift, max_keyframes=8, device=dev)
    for i in range(N_FRAMES):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    eng.finish(extra_solves=1)
    traj = eng.trajectory()
    rmse, n = evaluate_ate_rmse(traj, seq["poses"][: len(traj)])
    inv = {k: int(v) for k, v in check_invariants(eng.table).items()}
    fails = int(eng.table.num_alloc_failures)

    d = eng.render(traj[0])["depth"].cpu().numpy()
    gt = resample_nearest(torch.from_numpy(seq["depth"][0]), app.integration_height,
                          app.integration_width).numpy()
    hit = np.isfinite(d) & np.isfinite(gt)
    err = float(np.median(np.abs(d[hit] - gt[hit]))) if hit.any() else float("inf")
    verts, _ = eng.extract_mesh()
    out = {"platform": common.platform(dev), "frames": N_FRAMES, "valid_frames": n,
           "ate_rmse_cm": rmse * 100, "invariants": inv, "alloc_failures": fails,
           "render_hit_pixels": int(hit.sum()), "render_median_abs_err_m": err,
           "mesh_vertices": int(len(verts))}
    common.write_json(a.out, "verify_drive.json", out)
    print(json.dumps(out), flush=True)
    checks = {
        "all frames valid": n == N_FRAMES,
        "ATE under 6 cm": rmse < 0.06,
        "invariants clean, no allocation failure": not any(inv.values()) and fails == 0,
        "render within 3 voxels": hit.sum() > 1000 and err < 3 * app.sdf_voxel_size,
        "mesh over 10 000 vertices": len(verts) > 10000,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"verify drive failed: {failed}: {out}")
    print("VERIFY OK", flush=True)
    return out


if __name__ == "__main__":
    main()
