"""The greedy Kabsch filter's edge cases, as seeded numpy inputs: shared by
``tests/test_torch_kabsch_filter.py`` (the plain version against the JAX
package, on the CPU) and ``tests/test_torch_cuda.py`` (the kernel against
the plain version, on the card). Imports no JAX.

Each case is a function returning ``(arrays, check)``: the five inputs of
``kabsch_filter`` ([P, R, 3] points, [P, R, 2] pixels, [P, R] valid) and a
function that asserts what the case is about on a result dict.
"""

import numpy as np
import torch

from bundlefusion_tpu_torch.geometry.kabsch import kabsch_fast

T_ATOL = 1e-4
R_RAW = 128
MAX_FILTERED, MIN_MATCHES, MAX_RES2 = 25, 4, 4e-4


def _rigid(rng):
    """Random small rigid transform (as ``tests/test_filter_oracle.py`` draws it)."""
    w = rng.normal(scale=0.2, size=3)
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(scale=0.3, size=3)
    return T


def _pair(src, tgt, rng, r_cap=R_RAW):
    """One pair's arrays from its n valid matches, padded to ``r_cap``,
    with pixels 13 px apart (no accidental 5 px dedup)."""
    n = len(src)
    pix_s = rng.permutation(n)[:, None] * 13.0 + np.array([[7.0, 11.0]])
    pix_t = rng.permutation(n)[:, None] * 13.0 + np.array([[5.0, 3.0]])
    pad = r_cap - n
    return (np.concatenate([src, np.zeros((pad, 3))]).astype(np.float32),
            np.concatenate([tgt, np.zeros((pad, 3))]).astype(np.float32),
            np.concatenate([pix_s, np.full((pad, 2), 1e6)]).astype(np.float32),
            np.concatenate([pix_t, np.full((pad, 2), 1e6)]).astype(np.float32),
            np.arange(r_cap) < n)


def _rigid_points(rng, n, noise=1e-4):
    T = _rigid(rng)
    src = rng.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 3.0], size=(n, 3))
    return src, src @ T[:3, :3].T + T[:3, 3] + rng.normal(scale=noise, size=(n, 3))


def _batch(*pairs):
    if not pairs:
        return (np.zeros((0, R_RAW, 3), np.float32), np.zeros((0, R_RAW, 3), np.float32),
                np.zeros((0, R_RAW, 2), np.float32), np.zeros((0, R_RAW, 2), np.float32),
                np.zeros((0, R_RAW), bool))
    return tuple(np.stack([p[i] for p in pairs]) for i in range(5))


def _fit_residuals(src, tgt):
    """Squared residuals of the unweighted Horn fit of all given matches."""
    s, d = torch.from_numpy(src), torch.from_numpy(tgt)
    T, _ = kabsch_fast(s, d, torch.ones(len(src)))
    return T, ((s @ T[:3, :3].T + T[:3, 3] - d) ** 2).sum(-1)


def case_fewer_than_3():
    rng = np.random.default_rng(10)
    arrays = _batch(_pair(*_rigid_points(rng, 2), rng))

    def check(got):
        # accepted without a fit, then too few: identity, invalid
        assert not bool(got["valid_pair"][0]) and int(got["count"][0]) == 0
        assert torch.equal(got["transform"][0], torch.eye(4))
    return arrays, check


def case_all_invalid():
    rng = np.random.default_rng(11)
    src, tgt, ps, pt, _ = _pair(*_rigid_points(rng, 30), rng)
    arrays = _batch((src, tgt, ps, pt, np.zeros(R_RAW, bool)))

    def check(got):
        assert not bool(got["inlier_mask"].any()) and not bool(got["valid_pair"][0])
        assert torch.equal(got["transform"][0], torch.eye(4))
    return arrays, check


def case_revert_at_3():
    # four matches with no rigid motion among any three of them: the fourth
    # add fits all four, strips the worst, is still bad at 3 and reverts
    rng = np.random.default_rng(12)
    src = rng.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 3.0], size=(4, 3))
    tgt = rng.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 3.0], size=(4, 3))
    arrays = _batch(_pair(src, tgt, rng))
    T4, res4 = _fit_residuals(arrays[0][0, :4], arrays[1][0, :4])
    assert float(res4.max()) > MAX_RES2

    def check(got):
        # the post-add transform (the fit of all four) is what stays
        assert not bool(got["valid_pair"][0])
        np.testing.assert_allclose(got["transform"][0].numpy(), T4.numpy(), rtol=0,
                                   atol=T_ATOL)
    return arrays, check


def case_tie_for_worst():
    # matches 2 and 3 are the same points (their residuals are equal under
    # any fit), off by 5 cm in the target: two rigid matches, the twins,
    # then four more rigid ones. At the fifth match the fit of all five has
    # the twins as its two equal worst inliers; the first is stripped.
    rng = np.random.default_rng(4)
    off = rng.normal(size=3) * 0.05
    src, tgt = _rigid_points(rng, 8)
    src[3] = src[2]
    tgt[2] = tgt[2] + off
    tgt[3] = tgt[2]
    arrays = _batch(_pair(src, tgt, rng))
    _, res5 = _fit_residuals(arrays[0][0, :5], arrays[1][0, :5])
    assert float(res5[2]) == float(res5[3]) > MAX_RES2
    assert float(res5[2]) > float(res5[[0, 1, 4]].max())

    def check(got):
        assert bool(got["valid_pair"][0])
        assert not bool(got["inlier_mask"][0, 2]) and not bool(got["inlier_mask"][0, 3])
    return arrays, check


def case_fills_max_filtered():
    rng = np.random.default_rng(13)
    arrays = _batch(_pair(*_rigid_points(rng, 40), rng))

    def check(got):
        assert bool(got["valid_pair"][0]) and int(got["count"][0]) == MAX_FILTERED
        assert got["inlier_mask"][0].nonzero().flatten().tolist() == list(range(MAX_FILTERED))
    return arrays, check


def case_no_pairs():
    def check(got):
        assert got["inlier_mask"].shape == (0, R_RAW) and got["transform"].shape == (0, 4, 4)
        assert got["host_reads"] == 0
    return _batch(), check


CASES = {
    "fewer_than_3": case_fewer_than_3,
    "all_invalid": case_all_invalid,
    "revert_at_3": case_revert_at_3,
    "tie_for_worst": case_tie_for_worst,
    "fills_max_filtered": case_fills_max_filtered,
    "no_pairs": case_no_pairs,
}
