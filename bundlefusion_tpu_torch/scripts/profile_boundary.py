"""Device time of one submap boundary at capacity, part by part.

Counterpart of ``scripts/profile_boundary.py``. It builds the global problem
of a loop-dense scan directly: G keyframes, 25 correspondences per image
pair (the reference's filtered cap, ``GlobalDefines.h:9``), sequential pairs
plus loop closures into an anchor region from every third keyframe (the
quadratic regime of long scans). At G = 640 that is 4 199 pairs and 104 975
rows. Each part of a boundary is timed alone by CUDA events (median of 5
after one untimed call): ``presort_corrs`` (working-set selection and pair
segmentation), ``solve_sparse_presorted`` (3 GN steps), ``max_residual_sorted``
(what a pruning round acts on), a full prune round (invalidate and re-solve) and
``invalidate_image_pair`` on the store; ``boundary_model_ms`` adds them up as
a boundary with 3 prune rounds. On the CPU every part runs once and no time
is taken (null). Writes ``<out>/profile_boundary.json``.

``boundary_calls`` with ``solver_params`` below the problem's rows and
pairs drives the two overflow regimes of ``sort_corrs_by_pair``.

Usage:
  python -m bundlefusion_tpu_torch.scripts.profile_boundary [G] [corrs_per_pair]
      [--device cpu] [--out DIR]
"""

from __future__ import annotations

import copy
import json

import numpy as np
import torch

from bundlefusion_tpu_torch.scripts import common

PRUNE_ROUNDS = 3


def build_problem(G: int, per_pair: int, rng) -> dict:
    """The loop-dense pose graph (``scripts/profile_boundary.py:34-80``, the
    same draws from ``rng``): true poses ``gt`` [G, 6] as [omega, t], the
    perturbed start ``init`` (pose 0 exact), the store's fields at capacity
    ``cap`` (rows in pair order, ``count`` appended), the pair count and the
    row count."""
    from bundlefusion_tpu_torch.geometry.lie import pose_to_matrix

    t = np.arange(G) * 0.05
    gt = np.zeros((G, 6), np.float32)
    gt[:, 1] = 0.02 * t          # slow yaw
    gt[:, 3] = np.cos(0.2 * t)
    gt[:, 4] = np.sin(0.2 * t)

    pairs = []
    for i in range(1, G):
        for j in range(max(0, i - 4), i):       # local chain
            pairs.append((i, j))
        # loop closures into the anchor region: one keyframe in three sees it
        if i % 3 == 0:
            for j in rng.choice(max(1, i - 20), size=min(8, max(1, i - 20)), replace=False):
                pairs.append((i, int(j)))
    pairs = sorted(set(pairs))
    C = len(pairs) * per_pair
    cap = 1 << max(18, int(np.ceil(np.log2(C * 1.3))))

    Tm = pose_to_matrix(torch.from_numpy(gt)).numpy()
    ii, jj, pi, pj = [], [], [], []
    for a, b in pairs:
        world = rng.uniform(-1, 1, size=(per_pair, 3)).astype(np.float32)
        world[:, 2] += 2.0
        Ta, Tb = np.linalg.inv(Tm[a]), np.linalg.inv(Tm[b])
        ii.append(np.full(per_pair, a, np.int32))
        jj.append(np.full(per_pair, b, np.int32))
        pi.append(world @ Ta[:3, :3].T + Ta[:3, 3])
        pj.append(world @ Tb[:3, :3].T + Tb[:3, 3])
    init = gt + rng.normal(size=gt.shape).astype(np.float32) * 0.01
    init[0] = gt[0]

    def pad(x, fill):
        out = np.full((cap,) + x.shape[1:], fill, x.dtype)
        out[:C] = x
        return out

    arrays = {
        "img_i": pad(np.concatenate(ii), -1),
        "img_j": pad(np.concatenate(jj), -1),
        "p_i": pad(np.concatenate(pi).astype(np.float32), 0.0),
        "p_j": pad(np.concatenate(pj).astype(np.float32), 0.0),
        "key_i": np.zeros(cap, np.int32),
        "key_j": np.zeros(cap, np.int32),
        "count": np.asarray(C, np.int32),
    }
    return {"G": G, "gt": gt, "init": init, "arrays": arrays, "pairs": len(pairs),
            "corrs": C, "capacity": cap}


def solver_params(max_pairs: int = 1 << 18, max_working_corrs: int = 1 << 22):
    from bundlefusion_tpu_torch.solver.gn_pcg import SolverParams

    return SolverParams(num_gn=3, num_pcg=150, max_pairs=max_pairs,
                        max_working_corrs=max_working_corrs)


def boundary_calls(problem: dict, params, dev, reps: int = 5) -> dict:
    """The boundary's parts on ``dev``, each timed (None off the card), and
    their results as numpy: the working set the solve saw (``img_i`` /
    ``img_j`` / ``valid`` in sorted order), ``dropped``, the solved poses,
    the largest residual and its pair, the poses after one prune round."""
    from bundlefusion_tpu_torch.solver.gn_pcg import (
        cost,
        invalidate_pair_sorted,
        max_residual_sorted,
        presort_corrs,
        solve_sparse_presorted,
    )
    from bundlefusion_tpu_torch.solver.residuals import (
        corr_store_from_numpy,
        invalidate_image_pair,
    )

    G = problem["G"]
    store = corr_store_from_numpy(problem["arrays"], dev)
    poses = torch.from_numpy(problem["init"]).to(dev)
    kv = torch.ones((G,), dtype=torch.bool, device=dev)

    t = {}
    t["presort_ms"], prob = common.event_ms(dev, lambda: presort_corrs(store, G, params), reps)
    t["solve_ms"], sposes = common.event_ms(
        dev, lambda: solve_sparse_presorted(poses, kv, prob, params), reps)
    t["max_residual_ms"], (mr, fa, fb) = common.event_ms(
        dev, lambda: max_residual_sorted(sposes, prob), reps)

    def prune_round():
        return solve_sparse_presorted(poses, kv, invalidate_pair_sorted(prob, fa, fb), params)

    t["prune_round_ms"], pruned = common.event_ms(dev, prune_round, reps)
    t["invalidate_store_ms"], _ = common.event_ms(
        dev, lambda: invalidate_image_pair(copy.copy(store), fa, fb), reps)
    sc = prob.sc
    return {
        "times": t,
        "dropped": int(sc.dropped),
        "working_img_i": sc.img_i.cpu().numpy(),
        "working_img_j": sc.img_j.cpu().numpy(),
        "working_valid": sc.valid.cpu().numpy(),
        "poses": sposes.cpu().numpy(),
        "poses_after_prune": pruned.cpu().numpy(),
        "max_residual": float(mr),
        "worst_pair": [int(fa), int(fb)],
        "cost_initial": float(cost(poses, store)),
        "cost_final": float(cost(sposes, store)),
    }


def main(argv=None) -> dict:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("G", type=int, nargs="?", default=640)
    p.add_argument("per_pair", type=int, nargs="?", default=25)
    a = p.parse_args(argv)
    dev = common.resolve_device(a.device)
    common.reset_peak(dev)
    problem = build_problem(a.G, a.per_pair, np.random.default_rng(0))
    params = solver_params()
    r = boundary_calls(problem, params, dev)
    t = r["times"]
    res = {
        "platform": common.platform(dev), "G": a.G, "pairs": problem["pairs"],
        "corrs": problem["corrs"], "capacity": problem["capacity"],
        "params": {"max_pairs": params.max_pairs,
                   "max_working_corrs": params.max_working_corrs,
                   "num_gn": params.num_gn, "num_pcg": params.num_pcg},
        "timer": "cuda events, median of 5" if dev.type == "cuda" else "not measured (cpu)",
        "presort_ms": t["presort_ms"],
        "dropped": r["dropped"],
        "solve_ms": t["solve_ms"],
        "max_residual_ms": t["max_residual_ms"],
        "max_residual": r["max_residual"],
        "worst_pair": r["worst_pair"],
        "prune_round_ms": t["prune_round_ms"],
        "invalidate_store_ms": t["invalidate_store_ms"],
        "boundary_model_ms": (
            None if t["presort_ms"] is None else
            t["presort_ms"] + t["solve_ms"]
            + PRUNE_ROUNDS * (t["max_residual_ms"] + t["prune_round_ms"])),
        "cost_initial": r["cost_initial"],
        "cost_final": r["cost_final"],
        "max_abs_pose_err_vs_gt": float(np.abs(r["poses"] - problem["gt"]).max()),
        "peak_mem_gb": common.peak_mem_gb(dev),
    }
    common.write_json(a.out, "profile_boundary.json", res)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
