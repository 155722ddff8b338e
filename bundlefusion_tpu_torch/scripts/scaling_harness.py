"""Weak scaling of the engine over ranks: frames/s at 1 and 2 ranks.

Counterpart of ``scripts/scaling_harness.py``. The global problem grows
with the ranks (keyframe capacity 4 per rank, 512 global correspondences
per rank, two submaps of 10 per rank), so ideal weak scaling keeps frames/s
flat. Each rank count runs in new processes through
``parallel.mesh.run_ranks`` (``gloo``), on the small configuration's 160x120
synthetic orbit, rendered once here: 10 untimed frames, the rest timed, then
the pending boundaries retired and the valid frames counted on rank 0.

With one card both ranks share it (``cuda:0``) and one host: the result says
``"one_card": true``, and its frames/s ratio is no scaling number, only a
check that the mesh path runs. With ``--device cpu`` the ranks run on the
CPU. Writes ``<out>/scaling_harness.json``.

Usage:
  python -m bundlefusion_tpu_torch.scripts.scaling_harness [--ranks 1 2] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import json
import time

import numpy as np

from bundlefusion_tpu_torch.scripts import common

SUBMAP = 10


def n_frames_for(n: int) -> int:
    """Two submaps per rank: the same per-rank frame count at every n."""
    return 2 * (SUBMAP - 1) * n + 1


def _rank(mesh, seq, n: int):
    """One rank of an n-rank run (importable by name for ``run_ranks``)."""
    import torch

    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    # two intra-op threads per rank: ranks that each take every core of a
    # shared host run the small configuration many times slower
    torch.set_num_threads(2)
    intr, app, bundling, sift = common.small_config(submap_size=SUBMAP,
                                                    max_global_corr=512 * n)
    eng = BundleFusion(intr, app, bundling, sift_cfg=sift, max_keyframes=4 * n, mesh=mesh)
    n_frames = n_frames_for(n)
    for i in range(SUBMAP):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    common.sync(mesh.device)
    t0 = time.perf_counter()
    for i in range(SUBMAP, n_frames):
        eng.process_frame(seq["depth"][i], seq["color"][i])
    common.sync(mesh.device)
    fps = (n_frames - SUBMAP) / (time.perf_counter() - t0)
    eng._flush_pending()   # retire the boundaries in flight so validity is final
    ok = int(common.validity(eng.trajectory()).sum()) if mesh.rank == 0 else None
    return {"n": n, "fps": fps, "valid": ok, "frames": n_frames}


def main(argv=None) -> dict:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 2])
    a = p.parse_args(argv)
    dev = common.resolve_device(a.device)
    from bundlefusion_tpu_torch.io.synthetic import make_sequence
    from bundlefusion_tpu_torch.parallel.mesh import run_ranks

    intr = common.small_config()[0]
    seq_all = make_sequence(n_frames_for(max(a.ranks)), intr=intr, device=dev)
    seq = {k: seq_all[k] for k in ("depth", "color")}
    rank_dev = "cuda:0" if dev.type == "cuda" else "cpu"
    results = {}
    for n in a.ranks:
        nf = n_frames_for(n)
        part = {k: np.ascontiguousarray(v[:nf]) for k, v in seq.items()}
        res = run_ranks(_rank, n, part, n, backend="gloo", device=rank_dev, timeout=1800)
        results[str(n)] = res[0]
        print(res[0], flush=True)
    base = results.get("1")
    report = {
        "results": results,
        "platform": common.platform(dev),
        "one_card": dev.type == "cuda",
        "note": ("every rank shares one device and one host: frames/s at n ranks is "
                 "not a scaling number"),
    }
    if base:
        report["weak_scaling_efficiency"] = {k: v["fps"] / base["fps"]
                                             for k, v in results.items()}
    common.write_json(a.out, "scaling_harness.json", report)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
