"""Sparse bundle adjustment: Gauss-Newton with a direct or a PCG linear step.

Port of ``bundlefusion_tpu/solver/gn_pcg.py`` (the re-design of the
reference GPU solver, ``Solver/SolverBundling.cu``):

- variables: per-frame poses as 6-vectors [omega, t] in Lie space, the first
  pose fixed;
- sparse energy: r_c = T_i p_i - T_j p_j over the EntryJ correspondence
  store;
- pair-reduced systems: correspondences are sorted by pair id
  (img_i * N + img_j) once per solve; every Gauss-Newton iteration reduces
  the per-corr residuals and exact forward-mode Jacobian blocks over the
  sorted runs into per-pair 12x12 JtJ blocks and 12-vector Jtr; the linear
  step is either a direct LU solve of the reduced [6N, 6N] camera system
  (``linear="dense"``, and ``"auto"`` for N <= 2048) or block-Jacobi
  preconditioned conjugate gradients over the pair blocks (``"pcg"``);
- a boundary's residual-pruning rounds reuse one sort (``presort_corrs`` +
  ``solve_sparse_presorted``); pruning only flips validity bits.

What differs from the JAX module is what eager PyTorch makes different:

- ``lax.cond`` / ``while_loop`` on device values become host branches, each
  a counted device -> host read (``utils.read_host``): the Gauss-Newton
  early-out (one read per iteration but the last), the append cursor that
  bounds the working-set passes (one per sort of a large store), the PCG
  loop (one every ``PCG_CHECK_EVERY`` iterations; iterations past
  convergence are masked, so the result is the while loop's). The
  sort-or-identity choice above 65536 corrs is computed both ways under a
  mask and reads nothing. A submap's solve (``solve_local``) keeps the
  reference's masked Gauss-Newton loop instead: every step is enqueued,
  which costs a window's solve little and lets it run as a CUDA graph,
  where a masked step of the keyframe graph's solve would be one more
  factorisation of the whole system;
- segment sums run front to back over the sorted runs
  (``utils.segment_sum_sorted``), not as scatter-adds, so a solve on the
  card repeats bit for bit;
- the chunked passes with a skip past the live prefix are one pass over that
  prefix.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch.func import jvp, vmap

from bundlefusion_tpu_torch.geometry.lie import so3_exp
from bundlefusion_tpu_torch.solver.residuals import CorrStore
from bundlefusion_tpu_torch.utils import read_host, segment_sum_sorted, timing

_BIG = 2**31 - 1
PCG_CHECK_EVERY = 8

# Gauss-Newton steps whose direct solve failed (a singular factorisation or a
# non-finite result) and were replaced by no update, per device: a 0-d
# counter on that device, read by ``lu_zero_steps``.
_zero_steps = {}


def lu_zero_steps(device, reset: bool = False) -> int:
    """How many direct solves on ``device`` were zeroed so far (one read)."""
    t = _zero_steps.get(torch.device(device))
    n = 0 if t is None else int(read_host(t))
    if reset and t is not None:
        t.zero_()
    return n


def _chunk_size(C: int) -> Optional[int]:
    """Chunk length of the reference's capacity-C passes, or None for a
    single pass. Here it only decides whether a pass is worth bounding by
    the live prefix (one host read) instead of running over the whole
    capacity."""
    for kb in (262144, 65536, 16384):
        if C > kb and C % kb == 0:
            return kb
    return None


@dataclass(frozen=True)
class SolverParams:
    num_gn: int = 3                  # nonlinear iterations
    num_pcg: int = 150               # linear iterations
    pcg_early_out: float = 5e-7
    gn_early_out_delta: float = 0.005
    sparse_weight: float = 1.0
    max_pairs: int = 4096            # active (i, j) pair capacity
    max_working_corrs: int = 131072  # live corrs entering one solve; the
                                     # store can be far larger, and the
                                     # sort / gather work of a solve scales
                                     # with this; overflow shows in dropped
    linear: str = "auto"             # "dense" (direct LU on the reduced
                                     # [6N, 6N] system), "pcg", or
                                     # "auto" = dense for N <= 2048


class SolveStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_gn_done: torch.Tensor
    max_residual: torch.Tensor        # max per-axis component (SBA.cpp semantics)
    max_residual_corr: torch.Tensor   # corr index of the max residual
    num_pairs_dropped: torch.Tensor   # pairs beyond max_pairs (0 = exact solve)


def _use_dense(params: SolverParams, num_frames: int) -> bool:
    return params.linear == "dense" or (params.linear == "auto" and num_frames <= 2048)


def _res_batch(pose_i, pose_j, p_i, p_j):
    """r = T_i p_i - T_j p_j per correspondence: [c, 6] x2, [c, 3] x2 -> [c, 3]."""
    Ri = so3_exp(pose_i[..., :3])
    Rj = so3_exp(pose_j[..., :3])
    return ((Ri @ p_i[..., None])[..., 0] + pose_i[..., 3:]) - (
        (Rj @ p_j[..., None])[..., 0] + pose_j[..., 3:])


def _jac_batch(pose_i, pose_j, p_i, p_j):
    """Exact per-corr Jacobian d r / d [pose_i, pose_j]: [c, 3, 12], by
    forward mode over the 12 basis tangents."""
    x = torch.cat([pose_i, pose_j], -1)
    basis = torch.eye(12, dtype=x.dtype, device=x.device)[:, None, :].expand(12, *x.shape)

    def push(t):
        return jvp(lambda y: _res_batch(y[..., :6], y[..., 6:], p_i, p_j), (x,), (t,))[1]

    return vmap(push)(basis).permute(1, 2, 0)


def _gather_poses(poses, idx):
    return poses[torch.clamp(idx, 0, poses.shape[0] - 1).to(torch.int64)]


def _masked_residuals(poses, img_i, img_j, p_i, p_j, valid):
    """([c, 3] residuals of the rows under ``poses``, 0 where not ``valid``; valid)."""
    r = _res_batch(_gather_poses(poses, img_i), _gather_poses(poses, img_j), p_i, p_j)
    return torch.where(valid[:, None], r, 0.0), valid


def compute_residuals(poses, corrs: CorrStore):
    """[C, 3] residuals and [C] validity (invalid corrs -> 0 residual)."""
    return _masked_residuals(poses, corrs.img_i, corrs.img_j, corrs.p_i, corrs.p_j,
                             corrs.valid_mask())


def _cursor_bound(corrs: CorrStore, rows: Optional[int] = None) -> int:
    """How many leading rows of the store (or of its first ``rows`` rows) a
    pass must visit: up to the APPEND CURSOR for a large store (one host
    read), all rows for a small one. The bound is the cursor and not the
    live count: invalidation punches holes without moving the cursor, so
    live corrs sit anywhere below it until ``compact_corrs``."""
    C = corrs.capacity if rows is None else rows
    if _chunk_size(C) is None:
        return C
    return min(C, int(read_host(corrs.count)))


def _prefix_residuals(poses, corrs: CorrStore):
    n = _cursor_bound(corrs)
    return _masked_residuals(poses, corrs.img_i[:n], corrs.img_j[:n], corrs.p_i[:n],
                             corrs.p_j[:n], corrs.img_i[:n] >= 0)


def _argmax_masked(r, v):
    """(max |per-axis component| over valid rows or -1, its row or 0)."""
    dev = r.device
    if r.shape[0] == 0:
        return (torch.tensor(-1.0, device=dev), torch.tensor(0, device=dev))
    m = torch.where(v, r.abs().amax(-1), -1.0)
    i = torch.argmax(m)
    better = m[i] > -1.0
    return torch.where(better, m[i], -1.0), torch.where(better, i, 0)


def max_residual(poses, corrs: CorrStore):
    """Max |per-axis component| over valid corrs + its corr index
    (reference ``computeMaxResidual``; s_optMaxResThresh is per-axis)."""
    return _argmax_masked(*_prefix_residuals(poses, corrs))


def count_high_residuals(poses, corrs: CorrStore, thresh: float = 0.02):
    """Fraction-based verification (reference ``useVerification``):
    returns (num_high, num_valid)."""
    r, v = _prefix_residuals(poses, corrs)
    high = v & (r.abs().amax(-1) > thresh) if r.shape[0] else v
    return high.sum().to(torch.int32), v.sum().to(torch.int32)


def cost(poses, corrs: CorrStore):
    r, _ = _prefix_residuals(poses, corrs)
    return (r * r).sum()


# ---------------------------------------------------------------------------
# pair-reduced sparse system
# ---------------------------------------------------------------------------


class SortedCorrs(NamedTuple):
    """Correspondences sorted by pair id + the segment structure (fixed per
    solve, the analog of ``buildVariablesToCorrespondencesTableCUDA``)."""

    img_i: torch.Tensor     # [C] sorted
    img_j: torch.Tensor     # [C]
    p_i: torch.Tensor       # [C, 3]
    p_j: torch.Tensor       # [C, 3]
    valid: torch.Tensor     # [C] bool
    seg_id: torch.Tensor    # [C] pair/segment index of each sorted corr
                            #     (== max_pairs for dropped corrs)
    starts: torch.Tensor    # [P] segment start index into the sorted arrays
    ends: torch.Tensor      # [P] segment end index (inclusive)
    pair_i: torch.Tensor    # [P] pose index i of the pair
    pair_j: torch.Tensor    # [P]
    pair_valid: torch.Tensor  # [P] bool
    dropped: torch.Tensor   # [] int32: segments beyond the P cap


def _pair_chunk(P: int) -> Optional[int]:
    """Chunk length of the reference's per-PCG-iteration pair passes, or
    None for one pass over the pair capacity."""
    for pb in (32768, 8192):
        if P > pb and P % pb == 0:
            return pb
    return None


def _pid(img_i, img_j, valid, num_frames: int, fill: int):
    return torch.where(valid, img_i.to(torch.int64) * num_frames + img_j.to(torch.int64), fill)


def _first_true(mask, n: int):
    """Indices of the first ``n`` True entries in order, and how many of the
    ``n`` are real; read nothing back."""
    order = torch.sort((~mask).to(torch.int8), stable=True).indices[:n]
    return order, torch.arange(n, device=mask.device) < mask.sum()


def _ranked_working_indices(corrs: CorrStore, num_frames: int, working: int):
    """Pair-budgeted working-set selection for the overflow regime.

    Ranks every live corr by (round-robin rank within its pair, pair
    recency): rank 0 is each pair's newest corr, so every pair keeps about
    working / P corrs before any pair gets a second helping, and within a
    rank newer pairs (recent loop closures) win. Returns a [C] keep-mask,
    so the caller's stable compaction preserves the append order."""
    C = corrs.capacity
    dev = corrs.img_i.device
    idx = torch.arange(C, device=dev)
    v = corrs.valid_mask()
    pid_rev = _pid(corrs.img_i, corrs.img_j, v, num_frames, _BIG).flip(0)
    # group by pair, newest first within a pair: a stable sort of the
    # reversed array makes "newest" the stable winner
    o_pair = torch.argsort(pid_rev, stable=True)
    orig_g = C - 1 - o_pair           # original index of each grouped entry
    pid_g = pid_rev[o_pair]
    vg = pid_g != _BIG
    is_start = vg & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                               pid_g[1:] != pid_g[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank_g = torch.where(vg, idx - seg_start, _BIG)
    # pair recency = original index of the pair's newest corr; a smaller
    # key is a newer pair
    rec_g = orig_g[seg_start]
    key2_g = torch.where(vg, C - 1 - rec_g, _BIG)
    # lexicographic (rank, newest pair first): stable sort by key2, then rank
    o_b = torch.argsort(key2_g, stable=True)
    o_c = torch.argsort(rank_g[o_b], stable=True)
    sel = o_b[o_c[:working]]
    keep_pos = torch.where(rank_g[sel] != _BIG, orig_g[sel], C)
    keep = torch.zeros(C + 1, dtype=torch.bool, device=dev)
    keep[keep_pos] = True
    return keep[:C]


def sort_corrs_by_pair(corrs: CorrStore, num_frames: int, max_pairs: int,
                       working: Optional[int] = None) -> SortedCorrs:
    """Sort the corr store by (img_i, img_j) and find segment boundaries.

    ``working``: optional live-corr working capacity. When smaller than the
    store, the solve sees a window of that many rows: the store's first
    ``working`` rows while the append cursor has not passed them (holes from
    invalidation are tolerated: each is filled with the enclosing pair id,
    so a pair id still maps to one segment), else a pair-budgeted selection
    that keeps every pair's newest corrs (``_ranked_working_indices``); the
    excess shows in ``dropped``. That choice reads the cursor (one host
    read).

    Above 65536 rows a store that is already pid-sorted over its valid rows
    (the engine's stores are, by construction, until a revalidation appends
    out of order) keeps its order; the check and the sort are both computed
    and selected under a mask.
    """
    C = corrs.capacity
    dev = corrs.img_i.device
    img_i, img_j, p_i, p_j = corrs.img_i, corrs.img_j, corrs.p_i, corrs.p_j
    extra_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if working is not None and working < C:
        n_live_full = corrs.valid_mask().sum()
        if int(read_host(corrs.count)) > working:
            keep = _ranked_working_indices(corrs, num_frames, working)
            ci, ok = _first_true(keep, working)
            img_i = torch.where(ok, img_i[ci], -1)
            img_j = torch.where(ok, img_j[ci], -1)
            p_i = torch.where(ok[:, None], p_i[ci], 0.0)
            p_j = torch.where(ok[:, None], p_j[ci], 0.0)
        else:
            # a contiguous slice: order-preserving, no gathers
            img_i, img_j, p_i, p_j = img_i[:working], img_j[:working], p_i[:working], p_j[:working]
        C = working
        extra_dropped = torch.clamp(n_live_full - (img_i >= 0).sum(), min=0)
    v = img_i >= 0
    pid = _pid(img_i, img_j, v, num_frames, _BIG)
    order = torch.argsort(pid, stable=True)
    if C > 65536:
        # monotone over the valid rows (holes allowed): pid[k] >= every
        # earlier valid pid -> the identity order is a valid sort for the
        # hole-filling segment construction below
        pm = torch.cummax(torch.where(v, pid, -1), 0).values
        pm_prev = torch.cat([pm.new_full((1,), -1), pm[:-1]])
        vals_ok = (~v | (pid >= pm_prev)).all()
        order = torch.where(vals_ok, torch.arange(C, device=dev), order)
    img_i_s = img_i[order]
    img_j_s = img_j[order]
    v_s = img_i_s >= 0
    pid_s = _pid(img_i_s, img_j_s, v_s, num_frames, _BIG)
    # hole-filled pair ids: invalid entries inherit the previous valid pid,
    # so holes merge into the enclosing segment instead of splitting it
    pid_fill = torch.cummax(torch.where(v_s, pid_s, -1), 0).values
    prev_fill = torch.cat([pid_fill.new_full((1,), -1), pid_fill[:-1]])
    is_start = v_s & (pid_s != prev_fill)
    n_seg = is_start.sum()
    sq = torch.arange(max_pairs, device=dev)
    pair_valid = sq < n_seg
    # per-corr segment id: holes ride with the enclosing segment (the
    # validity masks zero them everywhere), entries before the first valid
    # corr map to segment 0 the same way, segments beyond the pair cap go to
    # the dropped bucket. Monotone by construction.
    cum_starts = torch.cumsum(is_start.to(torch.int64), 0)
    seg_id = torch.clamp(cum_starts - 1, 0, max_pairs)
    # cum_starts steps at each segment's first valid entry, so starts[s] is
    # the first position with cum_starts == s + 1; ends[s] includes trailing
    # holes riding the segment
    starts = torch.clamp(torch.searchsorted(cum_starts, sq + 1, right=False), 0, C - 1)
    ends = torch.clamp(torch.searchsorted(cum_starts, sq + 1, right=True) - 1, 0, C - 1)
    return SortedCorrs(
        img_i=img_i_s,
        img_j=img_j_s,
        p_i=p_i[order],
        p_j=p_j[order],
        valid=v_s,
        seg_id=seg_id,
        starts=starts,
        ends=ends,
        pair_i=torch.where(pair_valid, img_i_s[starts], 0),
        pair_j=torch.where(pair_valid, img_j_s[starts], 0),
        pair_valid=pair_valid,
        dropped=(torch.clamp(n_seg - max_pairs, min=0) + extra_dropped).to(torch.int32),
    )


def build_sparse_pair_system(poses, sc: SortedCorrs, w_sqrt, n_live: Optional[int] = None):
    """Per-GN-iteration reduction: exact per-corr Jacobians -> per-pair
    H [P, 12, 12] / b [P, 12] by an ordered segment sum over the sorted
    runs. Returns (H, b).

    ``n_live``: optional host bound on the rows that can be valid (the
    sorted arrays hold the live corrs below it); the pass then costs what
    the occupancy needs, not the capacity."""
    P_cap = sc.pair_valid.shape[0]
    C = sc.valid.shape[0]
    c = C if n_live is None else max(0, min(C, int(n_live)))
    vf = sc.valid[:c].to(torch.float32)[:, None] * w_sqrt
    pi = _gather_poses(poses, sc.img_i[:c])
    pj = _gather_poses(poses, sc.img_j[:c])
    r = _res_batch(pi, pj, sc.p_i[:c], sc.p_j[:c]) * vf            # [c, 3]
    J = _jac_batch(pi, pj, sc.p_i[:c], sc.p_j[:c]) * vf[..., None]  # [c, 3, 12]
    Hc = torch.einsum("cri,crj->cij", J, J)                        # [c, 12, 12]
    bc = torch.einsum("cri,cr->ci", J, r)                          # [c, 12]
    contrib = torch.cat([Hc.reshape(-1, 144), bc], -1)
    seg = segment_sum_sorted(contrib, sc.seg_id[:c], P_cap + 1)[:P_cap]
    seg = torch.where(sc.pair_valid[:, None], seg, 0.0)
    return seg[:, :144].reshape(-1, 12, 12), seg[:, 144:156]


class PairSeg(NamedTuple):
    """Segment structure for pair -> pose reductions, built once per solve:
    two [P, 6] gathers, one [P, 12, 12] block contraction and two sorted
    segment reductions make a matvec O(P)."""

    pair_i: torch.Tensor     # [P] pose index i (clamped for gathers)
    pair_j: torch.Tensor     # [P]
    order_i: torch.Tensor    # [P] permutation sorting pairs by i (identity
                             #     when pair_i arrives sorted)
    seg_i: torch.Tensor      # [P] pair_i[order_i], invalid -> N (sorted)
    order_j: torch.Tensor    # [P] permutation sorting pairs by j
    seg_j: torch.Tensor      # [P] pair_j[order_j], invalid -> N (sorted)


def make_pair_seg(pair_i, pair_j, pair_valid, num_frames: int,
                  assume_sorted_i: bool = True) -> PairSeg:
    """Build the reduction structure. With ``assume_sorted_i`` (the
    ``sort_corrs_by_pair`` contract: pairs come from a sort by
    pid = i * N + j, invalid pairs form the tail) the i-side permutation is
    the identity; pass False for pair lists that are only piecewise sorted."""
    N = num_frames
    pair_i, pair_j = pair_i.to(torch.int64), pair_j.to(torch.int64)
    i_key = torch.where(pair_valid, pair_i, N)
    j_key = torch.where(pair_valid, pair_j, N)
    if assume_sorted_i:
        order_i = torch.arange(pair_i.shape[0], device=pair_i.device)
        seg_i = i_key
    else:
        order_i = torch.argsort(i_key, stable=True)
        seg_i = i_key[order_i]
    order_j = torch.argsort(j_key, stable=True)
    return PairSeg(
        pair_i=torch.clamp(pair_i, 0, N - 1),
        pair_j=torch.clamp(pair_j, 0, N - 1),
        order_i=order_i,
        seg_i=seg_i,
        order_j=order_j,
        seg_j=j_key[order_j],
    )


def _seg_reduce(ps: PairSeg, val_i, val_j, N: int):
    """Sum per-pair i-side / j-side contributions [P, D] into per-pose rows
    [N, D]."""
    yi = segment_sum_sorted(val_i[ps.order_i], ps.seg_i, N + 1)
    yj = segment_sum_sorted(val_j[ps.order_j], ps.seg_j, N + 1)
    return yi[:N] + yj[:N]


def _pair_matvec_f32(H, ps: PairSeg, x, n_pairs: Optional[int] = None):
    """x [N, 6] -> sum_p S_p^T H_p S_p x via sorted segment reductions.
    Invalid pairs carry zero H blocks, so their gathered x contributions
    vanish.

    ``n_pairs``: optional host count of live pairs. Valid pairs are a prefix
    in both the pid order and the j-sorted order, so when it is given and
    the pair capacity is large, the passes run over the live prefix only,
    rounded up to the reference's chunk. Like the reference, that path
    takes the i-side order to be the identity (the ``sort_corrs_by_pair``
    contract), whatever ``ps.order_i`` holds."""
    N = x.shape[0]
    P = ps.seg_i.shape[0]
    PB = _pair_chunk(P)
    if n_pairs is None or PB is None:
        xij = torch.cat([x[ps.pair_i], x[ps.pair_j]], -1)         # [P, 12]
        y = torch.einsum("pab,pb->pa", H, xij)                    # [P, 12]
        return _seg_reduce(ps, y[:, :6], y[:, 6:], N)

    n = min(P, -(-int(n_pairs) // PB) * PB)

    def y_of(Hc, pic, pjc):
        return torch.einsum("pab,pb->pa", Hc, torch.cat([x[pic], x[pjc]], -1))

    yi = y_of(H[:n], ps.pair_i[:n], ps.pair_j[:n])[:, :6]
    oc = ps.order_j[:n]
    yj = y_of(H[oc], ps.pair_i[oc], ps.pair_j[oc])[:, 6:]
    acc = segment_sum_sorted(yi, ps.seg_i[:n], N + 1) + segment_sum_sorted(yj, ps.seg_j[:n], N + 1)
    return acc[:N]


def _pair_rhs(b, ps: PairSeg, N: int):
    return _seg_reduce(ps, b[:, :6], b[:, 6:], N)


def _pair_precond(H, ps: PairSeg, N: int):
    """Block-Jacobi 6x6 blocks: sum of each pose's ii/jj diagonal blocks."""
    Hii = H[:, :6, :6].reshape(-1, 36)
    Hjj = H[:, 6:, 6:].reshape(-1, 36)
    return _seg_reduce(ps, Hii, Hjj, N).reshape(N, 6, 6)


class PresortedProblem(NamedTuple):
    """One solve's sorted correspondence structure, reusable across the
    residual-pruning rounds of a submap boundary (pruning only flips
    validity bits, the sort order never changes)."""

    sc: SortedCorrs
    ps: PairSeg
    n_live: torch.Tensor   # [] one past the last valid entry in ``sc`` at
                           # sort time (holes may sit below it; invalidation
                           # never adds valid entries beyond it)
    inv_i: torch.Tensor    # [N*N] flat (i, j) -> pair index (P = none): the
                           # dense-assembly gather maps, built once per solve
    inv_j: torch.Tensor    # [N*N] flat (j, i) -> pair index
    bound: int             # host bound >= n_live for the working-set passes


def _pair_inverse_maps(ps: PairSeg, pair_valid, num_frames: int):
    """Inverse maps for dense assembly: for each flat block position
    r = a * N + b, the index of the pair whose (i, j) == (a, b) and of the
    pair whose (j, i) == (a, b). The positions are unique per valid pair;
    invalid pairs write to a spare last element."""
    N = num_frames
    P = ps.seg_i.shape[0]
    NN = N * N
    idx = torch.arange(P, device=pair_valid.device)
    fi = torch.where(pair_valid, ps.pair_i * N + ps.pair_j, NN)
    fj = torch.where(pair_valid, ps.pair_j * N + ps.pair_i, NN)
    inv_i = torch.full((NN + 1,), P, dtype=torch.int64, device=idx.device)
    inv_j = inv_i.clone()
    inv_i[fi] = idx
    inv_j[fj] = idx
    return inv_i[:NN], inv_j[:NN]


def presort_corrs(corrs: CorrStore, num_frames: int, params: SolverParams) -> PresortedProblem:
    P_cap = min(params.max_pairs, num_frames * (num_frames + 1) // 2 + 1)
    sc = sort_corrs_by_pair(corrs, num_frames, P_cap, working=params.max_working_corrs)
    ps = make_pair_seg(sc.pair_i, sc.pair_j, sc.pair_valid, num_frames)
    # one past the LAST valid entry: the identity-order path keeps
    # invalidation holes in place, so the live count is no valid bound
    Cw = sc.valid.shape[0]
    n_live = torch.where(sc.valid, torch.arange(Cw, device=sc.valid.device) + 1, 0).amax()
    # every valid row of the window lies below the append cursor (sorted:
    # the live rows are a prefix no longer than it; identity: they keep
    # their place; ranked: the window is full)
    bound = _cursor_bound(corrs, Cw)
    if _use_dense(params, num_frames):
        inv_i, inv_j = _pair_inverse_maps(ps, sc.pair_valid, num_frames)
    else:
        inv_i = inv_j = torch.zeros((0,), dtype=torch.int64, device=sc.valid.device)
    return PresortedProblem(sc=sc, ps=ps, n_live=n_live, inv_i=inv_i, inv_j=inv_j, bound=bound)


def _assemble_reduced(H, b, prob: PresortedProblem, free_f, N: int,
                      A_extra=None, rhs_extra=None):
    """The reduced camera system A = J^T J [6N, 6N] and right-hand side
    -J^T r [6N] from the per-pair 12x12 blocks, and the [N] mask of the
    poses that move.

    Off-diagonal (i, j) blocks are unique per pair, so the [N, N] block grid
    is gathered through the precomputed inverse maps; diagonal blocks are
    the block-Jacobi reduction. Fixed / invalid poses and poses with empty
    diagonal blocks get identity rows and columns, so their delta is exactly
    0."""
    P = H.shape[0]
    dev = H.device
    pad = H.new_zeros((1, 36))
    Hij = torch.cat([H[:, :6, 6:].reshape(P, 36), pad])
    Hji = torch.cat([H[:, 6:, :6].reshape(P, 36), pad])
    off = Hij[prob.inv_i]
    off += Hji[prob.inv_j]                                  # [NN, 36]
    diag = _pair_precond(H, prob.ps, N)                     # [N, 6, 6]

    A = off.reshape(N, N, 6, 6)
    ar = torch.arange(N, device=dev)
    A[ar, ar] += diag
    rhs = -_pair_rhs(b, prob.ps, N)                         # [N, 6]
    if A_extra is not None:
        A += A_extra
        diag = diag + A_extra[ar, ar]
    if rhs_extra is not None:
        rhs = rhs + rhs_extra

    # freeze fixed poses + poses with no constraints this solve
    strength = diag.diagonal(dim1=-2, dim2=-1).sum(-1)      # [N]
    act = (free_f[:, 0] > 0) & (strength > 1e-9)
    actf = act.to(torch.float32)
    A *= actf[:, None, None, None]
    A *= actf[None, :, None, None]
    reg = torch.where(act, 1e-6 * torch.clamp(strength, min=1.0), 1.0)
    A[ar, ar] += torch.eye(6, device=dev) * reg[:, None, None]
    rhs = rhs * actf[:, None]
    return A.permute(0, 2, 1, 3).reshape(6 * N, 6 * N), rhs.reshape(6 * N), actf


def _dense_reduced_solve(H, b, prob: PresortedProblem, free_f, N: int,
                         A_extra=None, rhs_extra=None):
    """Solve the reduced camera system A delta = -J^T r directly (LU,
    ``torch.linalg.solve_ex``). A failed factorisation (singular after
    aggressive pruning) must not poison the trajectory: the step becomes no
    update, and is counted (``lu_zero_steps``)."""
    timing.count("lu_steps")
    Ad, rhs, actf = _assemble_reduced(H, b, prob, free_f, N, A_extra, rhs_extra)
    delta, info = torch.linalg.solve_ex(Ad, rhs[:, None])
    delta = delta.reshape(N, 6) * actf[:, None]
    ok = (info == 0) & torch.isfinite(delta).all()
    dev = H.device
    counter = _zero_steps.get(dev)
    if counter is None:
        counter = _zero_steps[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    counter += (~ok).to(torch.int64)
    return torch.where(ok, delta, 0.0)


def _pcg(A, apply_P, rhs, params: SolverParams):
    """Preconditioned conjugate gradients from x = 0: the reference's while
    loop ``k < num_pcg and |rz| > pcg_early_out``. Iterations after the
    condition fails leave the state as it is, so the host only looks at the
    condition every ``PCG_CHECK_EVERY`` iterations to stop early. The
    iterations enqueued (masked ones included) go to the tracing log's
    ``pcg_iters`` counter."""
    x = torch.zeros_like(rhs)
    rr = rhs
    z = apply_P(rr)
    p = z
    rz = (rr * z).sum()
    iters = params.num_pcg
    for k in range(params.num_pcg):
        go = rz.abs() > params.pcg_early_out
        if k % PCG_CHECK_EVERY == 0 and not read_host(go):
            iters = k
            break
        Ap = A(p)
        pAp = (p * Ap).sum()
        alpha = torch.where(pAp.abs() > 1e-20, rz / pAp, 0.0)
        x_n = x + alpha * p
        rr_n = rr - alpha * Ap
        z_n = apply_P(rr_n)
        rz_n = (rr_n * z_n).sum()
        beta = torch.where(rz.abs() > 1e-20, rz_n / rz, 0.0)
        p_n = z_n + beta * p
        x, rr, z, p, rz = (torch.where(go, new, old) for new, old in
                           ((x_n, x), (rr_n, rr), (z_n, z), (p_n, p), (rz_n, rz)))
    timing.count("pcg_iters", iters)
    return x


def _gauss_newton(poses, params: SolverParams, step):
    """``num_gn`` iterations of ``poses <- step(poses, it)``, which returns
    (new poses, max |delta|); stops once a step's max |delta| is under the
    early-out (one host read per iteration but the last). Each step is one
    on the tracing log's ``gn_steps`` counter."""
    for it in range(params.num_gn):
        timing.count("gn_steps")
        poses, max_delta = step(poses, it)
        if it + 1 < params.num_gn and read_host(max_delta) < params.gn_early_out_delta:
            break
    return poses


def _gauss_newton_masked(poses, params: SolverParams, step, taken=None):
    """:func:`_gauss_newton` with the early-out as a mask on the device, the
    JAX reference's loop: all ``num_gn`` steps are enqueued, and once a
    step's max |delta| is under the early-out every later step returns its
    input. Nothing is read back, and the poses are those of the host
    early-out bit for bit. ``taken`` (an int64 tensor) gains one for each
    step whose update was applied; every step enqueued is one on
    ``gn_steps``."""
    done = torch.zeros((), dtype=torch.bool, device=poses.device)
    for it in range(params.num_gn):
        timing.count("gn_steps")
        new, max_delta = step(poses, it)
        if taken is not None:
            taken += (~done).to(torch.int64)
        poses = torch.where(done, poses, new)
        done = done | (max_delta < params.gn_early_out_delta)
    return poses


def _pcg_step(poses, H, rhs, precond, matvec_extra, ps, free_f, n_pairs, params):
    """One PCG linear step on the pair blocks (+ an optional extra operator)."""
    timing.count("pcg_steps")
    eye = torch.eye(6, device=poses.device) * 1e-6
    # like the reference's, a singular block's inverse is non-finite, not an error
    P_inv = torch.linalg.inv_ex(precond + eye).inverse

    def apply_P(x):
        return torch.einsum("nij,nj->ni", P_inv, x) * free_f

    def A(x):
        xf = x * free_f
        y = _pair_matvec_f32(H, ps, xf, n_pairs=n_pairs)
        if matvec_extra is not None:
            y = y + matvec_extra(xf)
        return y * free_f

    return _pcg(A, apply_P, rhs * free_f, params)


def solve_sparse_presorted(poses, pose_valid, prob: PresortedProblem, params: SolverParams):
    """GN over a presorted problem; returns the updated poses only (no cost
    / max-residual passes: callers in the pruning loop use
    ``max_residual_sorted``). The linear step is a direct dense reduced
    solve for moderate N, PCG otherwise (``SolverParams.linear``)."""
    return _gauss_newton(poses, params, _sparse_step(pose_valid, prob, params))


def _free_mask(pose_valid):
    """[N, 1] float mask of the poses a solve moves: valid, and not pose 0."""
    free = pose_valid & (torch.arange(pose_valid.shape[0], device=pose_valid.device) != 0)
    return free.to(torch.float32)[:, None]


def _sparse_step(pose_valid, prob: PresortedProblem, params: SolverParams):
    """The Gauss-Newton step ``step(poses, it) -> (poses, max |delta|)`` of
    the sparse energy over a presorted problem."""
    N = pose_valid.shape[0]
    w_sqrt = math.sqrt(params.sparse_weight)
    free_f = _free_mask(pose_valid)
    sc, ps = prob.sc, prob.ps

    if _use_dense(params, N):
        def step(p, _it):
            H, b = build_sparse_pair_system(p, sc, w_sqrt, n_live=prob.bound)
            delta = _dense_reduced_solve(H, b, prob, free_f, N)
            return p + delta * free_f, delta.abs().amax()
    else:
        n_pairs = None
        if _pair_chunk(ps.seg_i.shape[0]) is not None:
            n_pairs = int(read_host(sc.pair_valid.sum()))

        def step(p, _it):
            H, b = build_sparse_pair_system(p, sc, w_sqrt, n_live=prob.bound)
            delta = _pcg_step(p, H, -_pair_rhs(b, ps, N), _pair_precond(H, ps, N), None,
                              ps, free_f, n_pairs, params)
            return p + delta * free_f, delta.abs().amax()

    return step


def _sorted_prefix_residuals(poses, prob: PresortedProblem):
    sc, n = prob.sc, prob.bound
    return _masked_residuals(poses, sc.img_i[:n], sc.img_j[:n], sc.p_i[:n], sc.p_j[:n],
                             sc.valid[:n])


def max_residual_sorted(poses, prob: PresortedProblem):
    """Max |per-axis component| over the presorted working set + the image
    pair (fa, fb) of the argmax corr (fa = -1 when nothing is valid): the
    ``computeMaxResidual`` analog for the pruning loop, over the working
    set the solve actually saw."""
    mr, i = _argmax_masked(*_sorted_prefix_residuals(poses, prob))
    found = mr > -1.0
    return mr, torch.where(found, prob.sc.img_i[i], -1), torch.where(found, prob.sc.img_j[i], -1)


def invalidate_pair_sorted(prob: PresortedProblem, fa, fb) -> PresortedProblem:
    """Flip validity bits of all working-set corrs on pair (fa, fb); the
    sorted structure is otherwise unchanged (fully invalidated pairs
    contribute zero blocks through the validity weights)."""
    sc = prob.sc
    kill = ((sc.img_i == fa) & (sc.img_j == fb)) | ((sc.img_i == fb) & (sc.img_j == fa))
    return prob._replace(sc=sc._replace(valid=sc.valid & ~kill))


def apply_pair_kill_sorted(prob: PresortedProblem, killed, num_frames: int) -> PresortedProblem:
    """Apply a per-pair kill mask (``killed`` [N*N+1] bool, indexed by
    pid = i * N + j) to the working set."""
    sc = prob.sc
    pid = _pid(sc.img_i, sc.img_j, sc.valid, num_frames, num_frames * num_frames)
    return prob._replace(sc=sc._replace(valid=sc.valid & ~killed[pid]))


def corr_counts_per_frame_sorted(prob: PresortedProblem, num_frames: int):
    """Per-frame live-corr counts over the presorted WORKING set (the
    ``CheckForInvalidFrames`` input), as sorted segment sums over the live
    prefix. Counts only cover the working set the solver actually saw,
    consistent with the reference, which counts over the solver's residual
    set."""
    sc, n = prob.sc, prob.bound
    P_cap = sc.pair_valid.shape[0]
    pc = segment_sum_sorted(sc.valid[:n].to(torch.float32)[:, None], sc.seg_id[:n], P_cap + 1)
    pcf = pc[:P_cap]
    counts = _seg_reduce(prob.ps, pcf, pcf, num_frames)
    return counts[:, 0].to(torch.int32)


def _guided_kill(poses_now, poses_prev, v, img_i, img_j, p_i, p_j, cur_frame, mr,
                 num_frames: int, min_sep: int, mr_gate: float, prev_factor: float):
    NN = num_frames * num_frames
    hi_thresh = torch.clamp(0.2 * mr, 0.1, 0.4)

    def max_abs(poses):
        return _masked_residuals(poses, img_i, img_j, p_i, p_j, v)[0].abs().amax(-1)

    m_now, m_prev = max_abs(poses_now), max_abs(poses_prev)
    qual = (
        v & (mr > mr_gate)
        & (m_now > hi_thresh)
        & (img_i == cur_frame)
        & ((img_i - img_j).abs() > min_sep)
        & (m_prev > prev_factor * m_now)
    )
    killed = torch.zeros((NN + 1,), dtype=torch.bool, device=v.device)
    killed[_pid(img_i, img_j, qual, num_frames, NN)] = True
    killed[NN] = False
    return killed


def guided_kill_mask(poses_now, poses_prev, prob: PresortedProblem, cur_frame, mr,
                     num_frames: int, min_sep: int = 10, mr_gate: float = 0.2,
                     prev_factor: float = 1.5):
    """NEW_GUIDED_REMOVE analog (CUDASolverBundling.cpp:298-427) over the
    presorted working set: per-pair kill flags [N*N+1] for long-range pairs
    of the newest keyframe whose residual is high NOW and was
    ``prev_factor`` x higher under the previous trajectory (a bad loop
    closure, not drift)."""
    sc, n = prob.sc, prob.bound
    return _guided_kill(poses_now, poses_prev, sc.valid[:n], sc.img_i[:n], sc.img_j[:n],
                        sc.p_i[:n], sc.p_j[:n], cur_frame, mr, num_frames, min_sep, mr_gate,
                        prev_factor)


def guided_kill_mask_store(poses_now, poses_prev, corrs: CorrStore, cur_frame, mr,
                           num_frames: int, min_sep: int = 10, mr_gate: float = 0.2,
                           prev_factor: float = 1.5):
    """:func:`guided_kill_mask` over the whole store (the multi-device
    boundary prunes the store, not a presorted working set)."""
    n = _cursor_bound(corrs)
    return _guided_kill(poses_now, poses_prev, corrs.img_i[:n] >= 0, corrs.img_i[:n],
                        corrs.img_j[:n], corrs.p_i[:n], corrs.p_j[:n], cur_frame, mr,
                        num_frames, min_sep, mr_gate, prev_factor)


def apply_pair_kill_store(corrs: CorrStore, killed, num_frames: int) -> CorrStore:
    """Apply a per-pair kill mask to the full store, in place (bookkeeping
    twin of ``apply_pair_kill_sorted``)."""
    pid = _pid(corrs.img_i, corrs.img_j, corrs.valid_mask(), num_frames,
               num_frames * num_frames)
    corrs.img_i = torch.where(killed[pid], -1, corrs.img_i)
    return corrs


def _stats(poses_out, corrs, c0, params, dropped) -> SolveStats:
    mr, mr_idx = max_residual(poses_out, corrs)
    return SolveStats(
        initial_cost=c0,
        final_cost=cost(poses_out, corrs),
        num_gn_done=torch.tensor(params.num_gn),
        max_residual=mr,
        max_residual_corr=mr_idx,
        num_pairs_dropped=dropped,
    )


def solve_sparse(poses, pose_valid, corrs: CorrStore, params: SolverParams = SolverParams(),
                 num_frames_static: Optional[int] = None):
    """Run GN over the sparse 3D-3D energy.

    Args:
      poses: [N, 6] initial pose estimates ([omega, t], frame -> world).
      pose_valid: [N] bool; invalid poses are frozen (and their corrs should
        already be invalidated by the caller).
      corrs: correspondence store (not modified).

    Returns (poses, SolveStats).
    """
    N = poses.shape[0]
    prob = presort_corrs(corrs, N, params)
    c0 = cost(poses, corrs)
    poses_out = solve_sparse_presorted(poses, pose_valid, prob, params)
    return poses_out, _stats(poses_out, corrs, c0, params, prob.sc.dropped)


def solve_bundle(poses, pose_valid, corrs: CorrStore, cache, intr,
                 params: SolverParams = SolverParams(), dense_params=None,
                 dense_weights=None, w_color: float = 0.0):
    """Sparse + dense GN (the reference's full ``solveBundlingStub``): per
    GN iteration rebuild the dense pair system from the current poses, then
    solve A = J_s^T J_s + w_d * J_d^T J_d directly or by PCG with block-Jacobi
    preconditioning.

    Args:
      cache: DenseCache over the same frame indexing as ``corrs`` / poses.
      dense_weights: per-iteration dense-depth weights, a host sequence
        (reference schedules: local = iter + 1, global-at-end = 15).
      w_color: photometric weight (reference: 0.1 in the global-at-end solve).

    Returns (poses, SolveStats).
    """
    prob = presort_corrs(corrs, poses.shape[0], params)
    c0 = cost(poses, corrs)
    step = _bundle_step(pose_valid, prob, cache, intr, params, dense_params, dense_weights,
                        w_color)
    poses_out = _gauss_newton(poses, params, step)
    return poses_out, _stats(poses_out, corrs, c0, params, prob.sc.dropped)


def solve_local(poses, pose_valid, corrs: CorrStore, params: SolverParams, cache=None,
                intr=None, dense_params=None, taken=None):
    """A submap's bundle adjustment as its boundary runs it:
    :func:`solve_bundle` (given the window's dense ``cache``) or
    :func:`solve_sparse`, without their statistics, and with the
    Gauss-Newton early-out as a mask on the device
    (:func:`_gauss_newton_masked`; ``taken`` counts the steps applied). At
    a window's size the linear step is the direct one, and then nothing here
    reads the card back: the solve can be captured as a CUDA graph. Returns
    the poses, bit for bit those of the host early-out."""
    prob = presort_corrs(corrs, poses.shape[0], params)
    if cache is None:
        step = _sparse_step(pose_valid, prob, params)
    else:
        step = _bundle_step(pose_valid, prob, cache, intr, params, dense_params)
    return _gauss_newton_masked(poses, params, step, taken)


def _bundle_step(pose_valid, prob: PresortedProblem, cache, intr, params: SolverParams,
                 dense_params=None, dense_weights=None, w_color: float = 0.0):
    """The Gauss-Newton step ``step(poses, it) -> (poses, max |delta|)`` of
    the sparse + dense energy (:func:`solve_bundle`'s arguments)."""
    from bundlefusion_tpu_torch.solver.dense_term import (
        DenseTermParams,
        build_dense_system,
        dense_block_matrix,
        dense_matvec,
        dense_precond_blocks,
        dense_rhs,
        find_overlapping_pairs,
    )

    dp = dense_params or DenseTermParams()
    N = pose_valid.shape[0]
    if dense_weights is None:
        dense_weights = [float(i) for i in range(1, params.num_gn + 1)]
    dense_weights = [float(w) for w in dense_weights]
    w_sqrt = math.sqrt(params.sparse_weight)
    free_f = _free_mask(pose_valid)
    sc, ps = prob.sc, prob.ps
    use_dense_lin = _use_dense(params, N)
    n_pairs = None
    if not use_dense_lin and _pair_chunk(ps.seg_i.shape[0]) is not None:
        n_pairs = int(read_host(sc.pair_valid.sum()))

    def step(p, it):
        w_dense = dense_weights[min(it, len(dense_weights) - 1)]
        H, b = build_sparse_pair_system(p, sc, w_sqrt, n_live=prob.bound)
        pairs, pair_mask = find_overlapping_pairs(p, pose_valid, cache, intr, dp)
        dsys = build_dense_system(p, pairs, pair_mask, cache, intr, dp, 1.0, w_color)
        if use_dense_lin:
            delta = _dense_reduced_solve(
                H, b, prob, free_f, N,
                A_extra=w_dense * dense_block_matrix(dsys, N),
                rhs_extra=w_dense * dense_rhs(dsys, N),
            )
        else:
            delta = _pcg_step(
                p, H, -_pair_rhs(b, ps, N) + w_dense * dense_rhs(dsys, N),
                _pair_precond(H, ps, N) + w_dense * dense_precond_blocks(dsys, N),
                lambda xf: w_dense * dense_matvec(dsys, xf, N),
                ps, free_f, n_pairs, params,
            )
        return p + delta * free_f, delta.abs().amax()

    return step
