"""What the ranks of the mesh tests run (``parallel.mesh.run_ranks`` starts
them in fresh processes). Each function takes the rank's ``Mesh`` and numpy
inputs and returns numpy results, so the test modules can hold them against
the JAX package, which the rank processes never import."""

import numpy as np
import torch

torch.set_num_threads(1)  # several ranks share the test worker's cores


def _corrs(arrays, device):
    from bundlefusion_tpu_torch.solver.residuals import corr_store_from_numpy

    return corr_store_from_numpy(arrays, device)


def solver_scenarios(mesh, init, store, params):
    """The sharded solver two ways on one corr store, on the mesh's device:
    ``solve_sparse_sharded`` on this rank's chunk (and the collectives it
    costs), the engine's chunk solver on the replicated store."""
    from bundlefusion_tpu_torch.parallel.ba_sharded import (
        make_replicated_chunk_solver,
        shard_corrs,
        solve_sparse_sharded,
    )
    from bundlefusion_tpu_torch.solver.gn_pcg import SolverParams

    params = SolverParams(**params)
    dev = mesh.device
    full = _corrs(store, dev)
    n = init.shape[0]
    poses0 = torch.from_numpy(init).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    mesh.reset_stats()
    out, cost = solve_sparse_sharded(poses0, valid, shard_corrs(full, mesh), mesh, params)
    stats = dict(mesh.stats)
    solve = make_replicated_chunk_solver(mesh, n, full.capacity, params)
    chunk, dropped = solve(poses0, valid, full)
    return {"poses": out.cpu().numpy(), "cost": float(cost), "chunk_poses": chunk.cpu().numpy(),
            "dropped": int(dropped), "stats": stats}


def match_scenario(mesh, desc, cur, num_matches):
    """``match_descriptors_sharded`` of keyframe ``cur`` against the stack."""
    from bundlefusion_tpu_torch.parallel.ba_sharded import match_descriptors_sharded, shard_rows

    d = torch.from_numpy(desc)
    G, K = desc.shape[:2]
    m = match_descriptors_sharded(
        d[cur], torch.ones(K, dtype=torch.bool), shard_rows(d, mesh),
        shard_rows(torch.ones((G, K), dtype=torch.bool), mesh),
        shard_rows(torch.ones(G, dtype=torch.bool), mesh), mesh, num_matches=num_matches)
    return {k: v.numpy() for k, v in m._asdict().items()}


def map_scenarios(mesh, table, depths, colors, poses, intr, params):
    """The sharded integrate of two frames, and one frame integrated then
    de-integrated, each gathered into the whole table's payload, on the
    mesh's device (the CUDA kernels on a card); also the kernels' launches."""
    from bundlefusion_tpu_torch import kernels
    from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
    from bundlefusion_tpu_torch.parallel.map_sharded import (
        gather_payload,
        make_sharded_apply,
        shard_table_payload,
    )
    from bundlefusion_tpu_torch.tsdf.integrate import TsdfParams
    from bundlefusion_tpu_torch.tsdf.table import table_from_numpy

    intr, params = CameraIntrinsics(**intr), TsdfParams(**params)
    dev = mesh.device
    D, C, P = (torch.from_numpy(a).to(dev) for a in (depths, colors, poses))
    full = table_from_numpy(table, dev)
    apply = make_sharded_apply(mesh, full.num_blocks, intr, params)

    def np_payload(t):
        return {k: v.cpu().numpy().copy() for k, v in gather_payload(t, mesh).items()
                if k in ("sdf", "weight", "color")}

    launches0 = dict(kernels.launch_counts)
    t2 = apply(shard_table_payload(full, mesh), D, C, P, [1.0, 1.0], [0, 1])
    integrated = np_payload(t2)
    t1 = apply(shard_table_payload(full, mesh), D[:1], C[:1], P[:1], [1.0], [0])
    once = np_payload(t1)
    t1 = apply(t1, D[:1], C[:1], P[:1], [-1.0], [0])
    return {"integrated": integrated, "once": once, "round_trip": np_payload(t1),
            "shard_rows": int(t1.num_blocks),
            "launches": {k: v - launches0[k] for k, v in kernels.launch_counts.items()}}


def engine_scenarios(mesh, seq, n_frames, cfg, ckpt_dir):
    """The port engine over the mesh through its public entry points:
    ``warmup``, ``process_frame`` per frame (counting collectives and
    checking ``replicas_agree`` after every boundary), ``finish``; then
    ``save`` at the end and ``load(mesh=)`` resumed from it; and the
    keyframe-capacity check."""
    import bundlefusion_tpu_torch as port
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    def engine(**kw):
        return BundleFusion(port.CameraIntrinsics(**cfg["intr"]), port.AppConfig(**cfg["app"]),
                            port.BundlingConfig(**cfg["bundling"]),
                            sift_cfg=port.SiftConfig(**cfg["sift"]), mesh=mesh, **kw)

    eng = engine(max_keyframes=cfg["max_keyframes"])
    eng.warmup()
    sub_len = eng.S - 1
    calls, agree, outs = [], [], []
    for i in range(n_frames):
        c0 = mesh.stats["calls"]
        out = eng.process_frame(seq["depth"][i], seq["color"][i])
        calls.append(mesh.stats["calls"] - c0)
        outs.append(out["pose"] is None)
        if i > 0 and i % sub_len == 0:
            agree.append(eng.replicas_agree())
    eng.finish(extra_solves=1)
    agree.append(eng.replicas_agree())
    res = {
        "traj": eng.trajectory(), "kf_valid": eng.keyframe_valid.copy(),
        "num_keyframes": eng.num_keyframes, "frame_valid": list(eng.frame_valid),
        "calls_per_frame": calls, "agree": agree, "pose_is_none": outs,
        "poses": eng.glob.poses.numpy().copy(), "corr_count": int(eng.glob.corrs.count),
        "rank": mesh.rank, "single_path": not eng._use_mesh,
    }
    # save, then load onto the mesh: the replicas and the results carry over
    path = f"{ckpt_dir}/mesh.npz"
    eng.save(path)
    back = BundleFusion.load(path, mesh=mesh, device="cpu")
    res["loaded_agree"] = back.replicas_agree()
    res["loaded_equal"] = bool(
        torch.equal(back.glob.poses, eng.glob.poses)
        and torch.equal(back.kf_valid_dev, eng.kf_valid_dev)
        and np.array_equal(back.trajectory(), eng.trajectory(), equal_nan=True))
    res["loaded_holds_map"] = back.table is not None
    # keyframe capacity must split over the ranks
    try:
        engine(max_keyframes=cfg["max_keyframes"] * mesh.size + 1)
        res["capacity_error"] = None
    except ValueError as e:
        res["capacity_error"] = str(e)
    return res


def ba_scenarios(mesh, init, store, params, desc, cur, num_matches):
    """:func:`solver_scenarios` and :func:`match_scenario` in one group."""
    return {"solve": solver_scenarios(mesh, init, store, params),
            "match": match_scenario(mesh, desc, cur, num_matches)}
