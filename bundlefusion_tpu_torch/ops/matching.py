"""Batched SIFT descriptor matching.

Port of ``bundlefusion_tpu/ops/matching.py`` (the reference's all-pairs
descriptor products, mutual-best row / column match with distance and ratio
tests, and the per-pair sort, capped at 128 sorted matches). Descriptors are
unit vectors; the similarity of one image against a stack of previous images
is one batched matrix product, distance = sqrt(2 - 2 dot), and every later
step is a row / column reduction carried over the leading pair dimension
(the JAX version ``vmap``s a per-pair function).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_RAW_MATCHES = 128  # MAX_MATCHES_PER_IMAGE_PAIR_RAW (GlobalDefines.h:8)


class PairMatches(NamedTuple):
    """Raw matches for (a batch of) image pairs, sorted by distance."""

    idx_i: torch.Tensor     # [..., M] keypoint index in image i (current)
    idx_j: torch.Tensor     # [..., M] keypoint index in image j (previous)
    dist: torch.Tensor      # [..., M] descriptor distance
    valid: torch.Tensor     # [..., M] bool


def match_descriptors(desc_i, valid_i, desc_j, valid_j, dist_max: float = 0.7,
                      ratio_max: float = 0.8,
                      num_matches: int = MAX_RAW_MATCHES) -> PairMatches:
    """Mutual-best matching of one keypoint set against a stack of others.

    Args:
      desc_i: [K, 128] unit descriptors of the current image; valid_i: [K].
      desc_j: [P, K, 128] descriptors of P previous images; valid_j: [P, K].

    A match (a, b) survives iff: b = argmin_b d(a, b), a = argmin_a d(a, b),
    d < dist_max, and d / d_second < ratio_max (second-best in the row).
    Output is the top ``num_matches`` by ascending distance, leading dim P;
    ties keep the lower key index first.
    """
    big = 1e9
    K = desc_i.shape[0]
    # the reference multiplies bfloat16 operands and accumulates in float32;
    # a product of two bfloat16 values is exact in float32, so rounding the
    # operands and multiplying in float32 is the same sum
    a = desc_i.to(torch.bfloat16).to(torch.float32)
    b = desc_j.to(torch.bfloat16).to(torch.float32)
    sim = a @ b.transpose(-1, -2)                              # [P, K, K]
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0))
    mask = valid_i[None, :, None] & valid_j[:, None, :]
    dist = torch.where(mask, dist, big)

    row_best, best_j = torch.min(dist, dim=2)                  # [P, K]
    # second best in row for the ratio test
    row_second = dist.scatter(2, best_j[..., None], big).min(dim=2).values
    best_i = torch.argmin(dist, dim=1)                         # [P, K]
    mutual = best_i.gather(1, best_j) == torch.arange(K, device=dist.device)
    ok = mutual & (row_best < dist_max) & (row_best < ratio_max * row_second) & valid_i
    score = torch.where(ok, row_best, big)
    k = min(num_matches, K)
    top_d, top_i = torch.sort(score, dim=1, stable=True)
    top_d, top_i = top_d[:, :k], top_i[:, :k]
    if k < num_matches:  # pad to the fixed match cap
        pad = (top_d.shape[0], num_matches - k)
        top_d = torch.cat([top_d, top_d.new_full(pad, big)], 1)
        top_i = torch.cat([top_i, top_i.new_zeros(pad)], 1)
    return PairMatches(
        idx_i=top_i,
        idx_j=best_j.gather(1, top_i),
        dist=top_d,
        valid=top_d < dist_max,
    )


def match_descriptors_pair(desc_i, valid_i, desc_j, valid_j, dist_max: float = 0.7,
                           ratio_max: float = 0.8,
                           num_matches: int = MAX_RAW_MATCHES) -> PairMatches:
    """:func:`match_descriptors` for one pair: ``desc_j`` [K, 128]."""
    m = match_descriptors(desc_i, valid_i, desc_j[None], valid_j[None], dist_max, ratio_max,
                          num_matches)
    return PairMatches(*(x[0] for x in m))


def match_current_against_previous(desc_cur, valid_cur, desc_prev, valid_prev, active_prev,
                                   dist_max: float = 0.7, ratio_max: float = 0.8,
                                   num_matches: int = MAX_RAW_MATCHES) -> PairMatches:
    """Match the current image against a stack of previous images;
    ``active_prev`` [P] says which take part (invalid frames are skipped,
    as in ``Bundler::matchAndFilter``). Inactive pairs come back fully
    invalid."""
    m = match_descriptors(desc_cur, valid_cur, desc_prev, valid_prev, dist_max, ratio_max,
                          num_matches)
    return m._replace(valid=m.valid & active_prev[:, None])
