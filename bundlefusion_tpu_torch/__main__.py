"""CLI entry point: the ``FriedLiver`` main() analog of the port.

Usage:
  python -m bundlefusion_tpu_torch [appParams.txt] [bundlingParams.txt] [input]
  python -m bundlefusion_tpu_torch scene.sens --out out/
  python -m bundlefusion_tpu_torch tests/fixtures/tiny.sens --small --device cpu --out out/
  python -m bundlefusion_tpu_torch --synthetic 60 --out out/

Port of ``bundlefusion_tpu/__main__.py``: up to two parameter files in the
reference's ``key = value;`` format, then an input (a ``.sens`` file, a TUM
directory, or ``--synthetic N``), the full pipeline, and the reference's
shutdown sequence (``StopScanningAndExit``, DepthSensing.cpp:904-961): the
optimized trajectory written back into ``<out>/<seq>.sens`` for a ``.sens``
input, the marching-cubes mesh to ``<seq>.ply``, the ATE RMSE where the
input has true poses, and ``processed.txt`` with the validity verdict. The
port also writes the trajectory to ``trajectory.txt`` (one row-major 4x4 per
line). ``--dump-viz`` writes the final model view's depth, normals and
colour as images (needs ``cv2``).

``--max-frames`` caps the frames read from a ``.sens`` file or a TUM
directory, as in the reference; the port also applies it to
``--synthetic N``, which the reference ignores there. ``--small`` selects
CPU-sized capacities (for file inputs the resolutions follow the file).
A ``.sens`` depth stream decodes through the native codec in batches of 16;
JPEG / PNG colour and TUM images decode through ``cv2``.

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace as dataclasses_replace

import numpy as np


def _small_file_configs(app, bundling, intr, n):
    """CPU-friendly capacities for a file input (the reference's ``--small``
    branch for file inputs): (app, bundling, sift_cfg, max_keyframes)."""
    from bundlefusion_tpu_torch.ops.sift import SiftConfig

    app = dataclasses_replace(
        app, integration_width=intr.width // 2, integration_height=intr.height // 2,
        sdf_voxel_size=0.03, sdf_truncation=0.09, hash_num_sdf_blocks=8192,
        hash_key_capacity=16384, visible_blocks_cap=8192,
    )
    bundling = dataclasses_replace(
        bundling, width_sift=intr.width, height_sift=intr.height,
        submap_size=4, downsampled_width=intr.width // 4,
        downsampled_height=intr.height // 4,
        max_local_corr=2048, max_global_corr=8192,
        min_num_matches_local=4, min_num_matches_global=4,
    )
    sift_cfg = SiftConfig(
        num_octaves=3, target_keys=96, max_candidates_per_octave=256,
        min_scale=1.0, dog_thresh=0.004,
    )
    return app, bundling, sift_cfg, n // bundling.submap_size + 2


def _dump_viz(eng, traj, out_dir):
    """Render images of the final model view (the engine's last per-frame
    render, else a raycast from the last valid pose)."""
    from bundlefusion_tpu_torch.utils.visualization import (
        depth_to_color,
        normals_to_color,
        save_image,
    )

    ok_idx = [i for i in range(len(traj)) if np.isfinite(traj[i]).all()]
    if not ok_idx:
        return
    r = eng.last_render or eng.render(traj[ok_idx[-1]])
    r = {k: v.cpu().numpy() for k, v in r.items()}
    save_image(os.path.join(out_dir, "render_depth.png"), depth_to_color(r["depth"]))
    save_image(os.path.join(out_dir, "render_normals.png"), normals_to_color(r["normals"]))
    save_image(os.path.join(out_dir, "render_color.png"),
               np.clip(np.nan_to_num(r["color"]) * 255, 0, 255).astype(np.uint8))
    print(f"viz: render_{{depth,normals,color}}.png -> {out_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bundlefusion_tpu_torch")
    ap.add_argument("params", nargs="*", help="appParams [bundlingParams] [input]")
    ap.add_argument("--input", help=".sens file, TUM dir, or 'synthetic'")
    ap.add_argument("--synthetic", type=int, default=0, help="run N synthetic frames")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--small", action="store_true", help="small CPU-friendly config")
    ap.add_argument(
        "--dump-viz", action="store_true",
        help="write debug visualizations (rendered depth/normals/color of the "
        "final model view, SiftVisualization analog) into --out",
    )
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from bundlefusion_tpu_torch import default_device
    from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig, parse_parameter_file
    from bundlefusion_tpu_torch.io.ply import save_ply
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
    synthetic = bool(args.synthetic) or input_path in (None, "synthetic")
    if not synthetic and not os.path.exists(input_path):
        ap.error(f"input {input_path!r} does not exist (a .sens file or a TUM directory)")

    # no card and no --device: fail before any work
    device = torch.device(args.device) if args.device else default_device()
    os.makedirs(args.out, exist_ok=True)
    sift_cfg = None

    # ---- input source ----
    gt_poses = None
    sens_data = None
    if synthetic:
        from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, make_sequence
        from bundlefusion_tpu_torch.ops.sift import SiftConfig

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
        frames = ((seq["depth"][i], seq["color"][i]) for i in range(n))
        gt_poses = seq["poses"]
        seq_name = "synthetic"
    elif os.path.isdir(input_path):
        from bundlefusion_tpu_torch.io.tum import load_tum

        tum = load_tum(input_path)
        n = min(len(tum), args.max_frames or len(tum))
        intr = tum.intrinsics

        def tum_frames():
            for i in range(n):
                d, c, _ = tum.frame(i)
                yield d, c

        frames = tum_frames()
        if tum.gt:
            gt_poses = np.stack([
                p if p is not None else np.full((4, 4), np.nan)
                for p in (tum.frame(i)[2] for i in range(n))
            ])
        seq_name = os.path.basename(input_path.rstrip("/"))
        max_keyframes = n // bundling.submap_size + 2
    else:
        from bundlefusion_tpu_torch.io.sens import load_sens

        sens_data = load_sens(input_path, max_frames=args.max_frames)
        n = len(sens_data.frames)
        intr = sens_data.depth_intrinsics()

        def sens_frames():
            # batched depth decode through the native multithreaded codec
            # (RGBDFrameCacheRead-style prefetch)
            B = 16
            for s in range(0, n, B):
                e = min(n, s + B)
                depths = sens_data.decode_depth_batch(range(s, e))
                for k in range(s, e):
                    yield depths[k - s], sens_data.decode_color(k)

        frames = sens_frames()
        gt = sens_data.gt_trajectory()
        gt_poses = gt if np.isfinite(gt).any() else None
        seq_name = os.path.splitext(os.path.basename(input_path))[0]
        max_keyframes = n // bundling.submap_size + 2

    if args.small and not synthetic:
        app, bundling, sift_cfg, max_keyframes = _small_file_configs(app, bundling, intr, n)

    # ---- run ----
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift_cfg, max_keyframes=max_keyframes,
                       device=device)
    eng.warmup()
    t0 = time.perf_counter()
    n_done = 0
    # frame i + 1 uploads while frame i computes
    handle = None
    for depth, color in frames:
        nxt = eng.upload_frame(np.asarray(depth), np.asarray(color))
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

    if sens_data is not None:
        from bundlefusion_tpu_torch.io.sens import write_trajectory

        out_sens = os.path.join(args.out, f"{seq_name}.sens")
        write_trajectory(out_sens, sens_data, traj)
        print(f"trajectory written into {out_sens}")

    if args.dump_viz and len(traj):
        _dump_viz(eng, traj, args.out)

    ate = None
    if gt_poses is not None and len(traj):
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
    print("map staleness: " + json.dumps(eng.staleness()))
    return 0 if valid_run else 1


if __name__ == "__main__":
    sys.exit(main())
