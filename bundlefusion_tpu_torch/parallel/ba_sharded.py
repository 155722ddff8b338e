"""Multi-device sharded bundle adjustment and matching.

Port of ``bundlefusion_tpu/parallel/ba_sharded.py`` onto ``torch.distributed``
(``parallel/mesh.py``: one process per rank, SPMD). The design is the JAX
module's:

- **Correspondence sharding (BA)**: each rank holds a contiguous 1/n chunk
  of the EntryJ store (poses replicated), sorts it by pair id and reduces it
  into per-pair 12x12 JtJ blocks and 12-vector Jtr: the O(C) work. The pair
  structure is all-gathered once per solve, the [P_local, 156] blocks once
  per Gauss-Newton step, and the PCG then runs replicated on the gathered
  reduced system with no collective. The 3D-3D energy has no landmark
  variables, so combining the ranks' partials is a concatenation: a pair
  whose corrs straddle a chunk boundary contributes two additive blocks.
- **Keyframe sharding (matching)**: each rank matches the replicated current
  keyframe against its chunk of the previous keyframes' descriptors; the
  small per-pair results are all-gathered.

The math is the single-device solver's (``solver/gn_pcg.py``:
``sort_corrs_by_pair``, ``build_sparse_pair_system``, ``make_pair_seg`` and
the PCG step); this module only splits it over the ranks. Every rank calls
each function with the same arguments, apart from the store or descriptor
chunk that is its own, and gets the same (replicated) result.
"""

from __future__ import annotations

import math

import torch

from bundlefusion_tpu_torch.ops.matching import PairMatches, match_current_against_previous
from bundlefusion_tpu_torch.parallel.mesh import AXIS, Mesh, all_gather, all_reduce, make_mesh
from bundlefusion_tpu_torch.solver.gn_pcg import (
    SolverParams,
    _gather_poses,
    _pair_precond,
    _pair_rhs,
    _pcg_step,
    _res_batch,
    build_sparse_pair_system,
    make_pair_seg,
    sort_corrs_by_pair,
)
from bundlefusion_tpu_torch.solver.residuals import CorrStore
from bundlefusion_tpu_torch.utils import read_host, timing

__all__ = ["AXIS", "Mesh", "make_mesh", "shard_rows", "shard_corrs", "make_replicated_chunk_solver",
           "solve_sparse_sharded", "match_descriptors_sharded"]


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous 1/n chunk of ``x`` along dim 0 (a view)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    c = n // mesh.size
    return x[mesh.rank * c:(mesh.rank + 1) * c]


def shard_corrs(corrs: CorrStore, mesh: Mesh) -> CorrStore:
    """This rank's share of a replicated corr store: its contiguous
    ``capacity / n`` chunk of rows (a copy); ``count`` stays replicated."""
    return CorrStore(
        **{name: shard_rows(getattr(corrs, name), mesh).clone()
           for name in ("img_i", "img_j", "p_i", "p_j", "key_i", "key_j")},
        count=corrs.count.clone(),
    )


def _chunk_store(img_i, img_j, p_i, p_j) -> CorrStore:
    z = torch.zeros_like(img_i)
    return CorrStore(img_i=img_i, img_j=img_j, p_i=p_i, p_j=p_j, key_i=z, key_j=z,
                     count=torch.zeros((), dtype=torch.int32, device=img_i.device))


def _pair_gather_gn(poses, free_f, sc, mesh: Mesh, params: SolverParams, w_sqrt: float):
    """The shared per-rank GN/PCG body: per-chunk pair-system build ->
    all-gather of the per-pair blocks -> replicated PCG. Returns (poses,
    the chunk's dropped pairs)."""
    N = poses.shape[0]
    # the pair -> pose structure, gathered once per solve; the gathered list
    # is sorted per chunk only, so the i side gets its own permutation
    pairs = all_gather(mesh, torch.stack([sc.pair_i.to(torch.int64), sc.pair_j.to(torch.int64),
                                          sc.pair_valid.to(torch.int64)], 1))
    ps = make_pair_seg(pairs[:, 0], pairs[:, 1], pairs[:, 2] > 0, N, assume_sorted_i=False)
    # one past the chunk's last valid sorted row: the block build's bound
    # (one read of this rank's own value; no decision depends on it)
    Cl = sc.valid.shape[0]
    n_live = read_host(torch.where(sc.valid, torch.arange(Cl, device=sc.valid.device) + 1,
                                   0).amax())
    done = torch.zeros((), dtype=torch.bool, device=poses.device)
    # all num_gn steps run: after the early-out ``done`` freezes the poses,
    # as the JAX loop does
    for _ in range(params.num_gn):
        timing.count("gn_steps")
        H, b = build_sparse_pair_system(poses, sc, w_sqrt, n_live=n_live)
        # the one collective per GN step: [P_local, 156] blocks from each rank
        Hb = all_gather(mesh, torch.cat([H.reshape(-1, 144), b], 1))
        Hg, bg = Hb[:, :144].reshape(-1, 12, 12), Hb[:, 144:]
        # the PCG runs replicated on the reduced system: no collective
        delta = _pcg_step(poses, Hg, -_pair_rhs(bg, ps, N), _pair_precond(Hg, ps, N), None,
                          ps, free_f, None, params)
        poses = torch.where(done, poses, poses + delta * free_f)
        done = done | (delta.abs().amax() < params.gn_early_out_delta)
    return poses, sc.dropped


def _free_f(pose_valid: torch.Tensor) -> torch.Tensor:
    N = pose_valid.shape[0]
    free = pose_valid & (torch.arange(N, device=pose_valid.device) != 0)
    return free.to(torch.float32)[:, None]


def make_replicated_chunk_solver(mesh: Mesh, num_frames: int, capacity: int,
                                 params: SolverParams = SolverParams()):
    """Sharded-compute solver over a REPLICATED corr store (the engine's
    mesh boundary): each rank takes its static 1/n chunk of the corr axis by
    rank index, builds the per-pair blocks of its chunk, and the reduced
    system is all-gathered as in :func:`solve_sparse_sharded`. Returns
    ``solve(poses, pose_valid, corrs) -> (poses, dropped)``, both
    replicated (``dropped`` summed over the ranks)."""
    n = mesh.size
    if capacity % n:
        raise ValueError(f"corr capacity {capacity} does not split over {n} ranks")
    Cl = capacity // n
    # a contiguous chunk can hold more distinct pairs than a 1/n share of
    # the pair budget; its corr count bounds them, so no rank drops a pair
    # the single-device solve would keep
    P_local = min(params.max_pairs, Cl)
    w_sqrt = math.sqrt(params.sparse_weight)
    start = mesh.rank * Cl

    def solve(poses, pose_valid, corrs: CorrStore):
        sl = slice(start, start + Cl)
        local = _chunk_store(corrs.img_i[sl], corrs.img_j[sl], corrs.p_i[sl], corrs.p_j[sl])
        sc = sort_corrs_by_pair(local, num_frames, P_local)
        poses_out, dropped = _pair_gather_gn(poses, _free_f(pose_valid), sc, mesh, params,
                                             w_sqrt)
        return poses_out, all_reduce(mesh, dropped)

    return solve


def solve_sparse_sharded(poses, pose_valid, corrs: CorrStore, mesh: Mesh,
                         params: SolverParams = SolverParams()):
    """GN/PCG with a corr-sharded pair-system build and a replicated PCG.

    ``corrs`` is this rank's chunk (:func:`shard_corrs`). Same semantics as
    ``solve_sparse`` minus the per-corr max-residual statistics; returns
    (poses, final cost), both replicated. Each rank's pair capacity is
    ``min(params.max_pairs, chunk capacity)``."""
    N = poses.shape[0]
    P_local = min(params.max_pairs, corrs.capacity)
    local = _chunk_store(corrs.img_i, corrs.img_j, corrs.p_i, corrs.p_j)
    sc = sort_corrs_by_pair(local, N, P_local)
    poses, _ = _pair_gather_gn(poses, _free_f(pose_valid), sc, mesh, params,
                               math.sqrt(params.sparse_weight))
    # the final cost, summed over the chunks
    vf = (corrs.img_i >= 0).to(torch.float32)[:, None]
    r = _res_batch(_gather_poses(poses, corrs.img_i), _gather_poses(poses, corrs.img_j),
                   corrs.p_i, corrs.p_j) * vf
    return poses, all_reduce(mesh, (r * r).sum())


def match_descriptors_sharded(desc_cur, valid_cur, desc_prev, valid_prev, active_prev,
                              mesh: Mesh, dist_max: float = 0.7, ratio_max: float = 0.8,
                              num_matches: int = 128) -> PairMatches:
    """The current keyframe against the previous-keyframe stack, sharded
    over keyframes: ``desc_prev`` [G/n, K, 128], ``valid_prev`` [G/n, K] and
    ``active_prev`` [G/n] are this rank's chunk (:func:`shard_rows`), the
    current descriptors replicated. Returns the [G, M] matches of the whole
    stack, replicated (all-gathered in rank = slot order); a pair whose
    keyframe is not active comes back invalid."""
    m = match_current_against_previous(desc_cur, valid_cur, desc_prev, valid_prev, active_prev,
                                       dist_max, ratio_max, num_matches)
    return PairMatches(*(all_gather(mesh, x) for x in m))
