"""Peaks of the card and the bytes and operations of the hand kernels.

Frozen copies of ``chip_smoke.py``'s arithmetic (``_bound`` and the counts
of ``phase_kernels`` and ``phase_kabsch``), kept with the benchmark so that a
later change to the program cannot move them. A kernel's roofline share is
``bound_ms(...) / kernel ms``; no cell reports one yet: the sweep's bytes
follow the rows each ``tsdf_apply`` launch takes, and nothing counts them
inside a run so far (``PERF.md``, Open questions).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12

ROW_BYTES = 5 * 512 * 4     # sdf + weight + 3 colour channels of one payload row
FLOP_PER_VOXEL_OP = 40      # projection 18, two divisions, pixel 4, gate 4, update 12
FLOP_PER_CORNER = 30        # projection 18, two divisions, pixel 4, six min / max
# one greedy-filter fit: the 4x4 algebra once, and per masked match the
# weight, centroid, cross-covariance, covariance and residual terms
FLOP_PER_FIT = 1450
FLOP_PER_MASKED_MATCH = 110
# the surface-area filter: per match the moments, the plane projection and
# the box extents; per image two symmetric eigenproblems
FLOP_PER_AREA_MATCH = 110
FLOP_PER_AREA_SOLVE = 1500


def bound_ms(n_bytes: float, flop: float, flop_per_s: float = FP32_FLOP_PER_S):
    """(least ms the card could take, which limit sets it): the larger of
    the bytes over the memory's rate and the operations over the peak."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_flop = flop / flop_per_s * 1e3
    return max(by_bytes, by_flop), ("bytes" if by_bytes >= by_flop else "operations")


def tsdf_apply(rows: int, row_ops: int, images: int, sample_bytes: int):
    """The sweep: each row's payload read and written once (plus its key,
    slot and mask), each used image's samples read once; 40 operations a
    voxel and op."""
    return bound_ms(rows * (2 * ROW_BYTES + 12) + images * sample_bytes,
                    row_ops * 512 * FLOP_PER_VOXEL_OP)


def tsdf_prepare(images: int, height: int, width: int):
    """The image pass: depth and colour in (16 bytes a pixel), one float4
    sample out (16), each image's largest depth out; 20 operations a pixel."""
    return bound_ms(images * height * width * 32 + images * 4, images * height * width * 20)


def tsdf_cull(key_slots: int, rows: int, ops: int, live_rows: int, active_ops: int):
    """The cull: every slot key read, the row list and masks written, the op
    table read; 30 operations per block corner, op and live row."""
    return bound_ms(key_slots * 4 + rows * 12 + ops * 64 + 4,
                    live_rows * active_ops * 8 * FLOP_PER_CORNER)


def kabsch_filter(pairs: int, raw: int, fits: int, masked_matches: int):
    """The greedy filter: inputs once (points, pixels, valid: 42 bytes a
    raw match), outputs once (mask, count, transform, valid pair); the fits
    these inputs need."""
    return bound_ms(pairs * raw * (4 * 10 + 1 + 1) + pairs * (8 + 64 + 1),
                    fits * FLOP_PER_FIT + masked_matches * FLOP_PER_MASKED_MATCH)


def surface_area(pairs: int, matches: int):
    """The surface-area filter: inputs once (two point sets, the mask),
    outputs once (keep, two areas); every match of both images and their
    eigenproblems."""
    return bound_ms(pairs * matches * (12 + 12 + 1) + pairs * (1 + 4 + 4),
                    2 * pairs * (matches * FLOP_PER_AREA_MATCH + FLOP_PER_AREA_SOLVE))
