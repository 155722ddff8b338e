"""CLI entry point: the ``FriedLiver`` main() analog of the port.

Usage:
  python -m bundlefusion_tpu_torch --synthetic 60 --out out/
  python -m bundlefusion_tpu_torch [appParams.txt] [bundlingParams.txt] --synthetic 60
  python -m bundlefusion_tpu_torch --synthetic 9 --small --device cpu

Port of ``bundlefusion_tpu/__main__.py``: up to two parameter files in the
reference's ``key = value;`` format, then the full pipeline over the
synthetic sequence and the reference's shutdown sequence
(``StopScanningAndExit``, DepthSensing.cpp:904-961): the optimized
trajectory to ``trajectory.txt`` (one row-major 4x4 per line), the
marching-cubes mesh to ``synthetic.ply``, the ATE RMSE against the
sequence's true poses, and ``processed.txt`` with the validity verdict.

It runs on the CUDA card unless ``--device cpu`` is given. Recorded inputs
(``.sens`` files, TUM directories) and ``--dump-viz`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_NOT_PORTED = (
    "the PyTorch port reads only the synthetic sequence (--synthetic N); .sens and TUM "
    "readers are ROADMAP.md Queue 1 item 3.5"
)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bundlefusion_tpu_torch")
    ap.add_argument("params", nargs="*", help="appParams [bundlingParams] [input]")
    ap.add_argument("--input", help="'synthetic' (recorded inputs are not ported yet)")
    ap.add_argument("--synthetic", type=int, default=0, help="run N synthetic frames")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--small", action="store_true", help="small CPU-friendly config")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from bundlefusion_tpu_torch import default_device
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig, parse_parameter_file
    from bundlefusion_tpu_torch.io.ply import save_ply
    from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, make_sequence
    from bundlefusion_tpu_torch.ops.sift import SiftConfig
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion
    from bundlefusion_tpu_torch.utils.metrics import evaluate_ate_rmse

    app = AppConfig()
    bundling = BundlingConfig()
    pos = list(args.params)
    input_path = args.input
    if pos and pos[0].endswith(".txt"):
        app = parse_parameter_file(pos.pop(0), app)
    if pos and pos[0].endswith(".txt"):
        bundling = parse_parameter_file(pos.pop(0), bundling)
    if pos:
        input_path = pos.pop(0)
    if not (args.synthetic or input_path in (None, "synthetic")):
        ap.error(f"cannot read {input_path!r}: {_NOT_PORTED}")

    # no card and no --device: fail before any work
    device = torch.device(args.device) if args.device else default_device()
    os.makedirs(args.out, exist_ok=True)
    sift_cfg = None
    n = args.synthetic or 30
    if args.max_frames is not None:
        n = min(n, args.max_frames)
    if args.small:
        intr = default_intrinsics(160, 120)
        app = AppConfig(
            integration_width=80, integration_height=60, sdf_voxel_size=0.03,
            sdf_truncation=0.09, hash_num_sdf_blocks=8192,
            hash_key_capacity=16384, visible_blocks_cap=8192,
        )
        bundling = BundlingConfig(
            width_sift=160, height_sift=120, submap_size=4,
            downsampled_width=40, downsampled_height=30,
            max_local_corr=2048, max_global_corr=8192,
            min_num_matches_local=4, min_num_matches_global=4,
        )
        sift_cfg = SiftConfig(
            num_octaves=3, target_keys=96, max_candidates_per_octave=256,
            min_scale=1.0, dog_thresh=0.004,
        )
        max_keyframes = max(n // 4 + 2, 4)
    else:
        intr = default_intrinsics(640, 480)
        max_keyframes = max(n // bundling.submap_size + 2, 4)
    seq = make_sequence(n, intr=intr, device=device)
    gt_poses = seq["poses"]
    seq_name = "synthetic"

    # ---- run ----
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=max_keyframes,
                       device=device)
    eng.warmup()
    t0 = time.perf_counter()
    n_done = 0
    # frame i + 1 uploads while frame i computes
    handle = None
    for i in range(n):
        nxt = eng.upload_frame(np.asarray(seq["depth"][i]), np.asarray(seq["color"][i]))
        if handle is not None:
            out = eng.process_frame(handle)
            n_done += 1
            if n_done % 10 == 0:
                print(f"[ {n_done} ] valid={bool(out['valid'])} "
                      f"({n_done / (time.perf_counter() - t0):.2f} fps)", flush=True)
        handle = nxt
    if handle is not None:
        eng.process_frame(handle)
        n_done += 1
    eng.finish()
    elapsed = time.perf_counter() - t0

    traj = eng.trajectory()
    n_valid = int(np.isfinite(traj).all((1, 2)).sum()) if len(traj) else 0

    # ---- outputs (StopScanningAndExit) ----
    traj_path = os.path.join(args.out, "trajectory.txt")
    np.savetxt(traj_path, traj.reshape(len(traj), 16))
    print(f"trajectory: {len(traj)} poses -> {traj_path}")
    verts, cols = eng.extract_mesh()
    mesh_path = os.path.join(args.out, f"{seq_name}.ply")
    save_ply(mesh_path, verts, cols)
    print(f"mesh: {verts.shape[0]} triangles -> {mesh_path}")

    ate = None
    if len(traj):
        rmse, n_eval = evaluate_ate_rmse(traj, gt_poses[: len(traj)])
        ate = rmse
        print(f"ATE RMSE: {rmse * 100:.2f} cm over {n_eval} frames")

    valid_run = n_valid >= max(1, n_done // 2)
    verdict = {
        "valid": bool(valid_run),
        "numValidOptTransforms": n_valid,
        "numTransforms": n_done,
        "heapFreeCount": int(eng.table.free_count),
        "fps": n_done / elapsed if elapsed > 0 else 0.0,
    }
    if ate is not None:
        verdict["ate_rmse_m"] = ate
    with open(os.path.join(args.out, "processed.txt"), "w") as fh:
        fh.write(json.dumps(verdict, indent=1))
    print(json.dumps(verdict))
    eng.timing.print_all_timings()
    return 0 if valid_run else 1


if __name__ == "__main__":
    sys.exit(main())
