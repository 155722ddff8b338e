"""The surface-area filter's edge cases, as seeded numpy inputs: shared by
``tests/test_torch_surface_area.py`` (the plain version against the JAX
package, on the CPU) and ``tests/test_torch_cuda.py`` (the kernel against
the plain version, on the card). Imports no JAX.

Each case is a function returning ``(arrays, check)``: the three inputs of
``surface_area_filter`` ([P, R, 3] source and target points, [P, R] inlier
mask) and a function that asserts what the case is about on a result
``(keep, a0, a1)`` of numpy arrays.

Tolerance: areas agree to ``AREA_ATOL`` absolute or ``AREA_RTOL`` relative
(float32 sums in another order, and eigenvectors from another solver: both
move an area by rounding only). Where the reference is ill-posed, that is
where an image's 3x3 covariance has its two smallest eigenvalues, or its
plane's 2x2 covariance its two eigenvalues, within ``GAP_RTOL`` of each other
(relative to the largest), the plane or the box's axes are not defined by
the points and any answer is accepted: :func:`compare` skips those images'
areas and their pair's keep flag (the cases' own checks still hold them to
what is certain, such as an area of 0).
"""

import numpy as np

AREA_ATOL = 1e-5
AREA_RTOL = 1e-4
GAP_RTOL = 1e-3
THRESH = 0.032       # surf_area_pca_thresh
R_RAW = 128


def _rotation(rng):
    w = rng.normal(scale=0.6, size=3)
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _placed(rng, local):
    """[n, 3] points of a local frame, turned and moved to about 2 m ahead."""
    return local @ _rotation(rng).T + np.array([0.1, -0.05, 2.0]) + rng.normal(scale=0.2, size=3)


def _pair(src, tgt, mask_n=None, r_cap=R_RAW):
    """One pair padded to ``r_cap`` matches; the first ``mask_n`` (default
    all given) are inliers."""
    n = len(src)
    pad = r_cap - n
    m = np.zeros(r_cap, bool)
    m[:n if mask_n is None else mask_n] = True
    return (np.concatenate([src, np.zeros((pad, 3))]).astype(np.float32),
            np.concatenate([tgt, np.zeros((pad, 3))]).astype(np.float32), m)


def _batch(*pairs):
    return tuple(np.stack([p[i] for p in pairs]) for i in range(3))


def _rect(a, b, n=5):
    """An n x n grid spanning the a x b rectangle (corners included), z = 0."""
    u, v = np.meshgrid(np.linspace(-a / 2, a / 2, n), np.linspace(-b / 2, b / 2, n))
    return np.stack([u.ravel(), v.ravel(), np.zeros(n * n)], -1)


def _line(rng, n, length=0.5):
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    return np.array([0.2, 0.1, 2.0]) + np.linspace(-length / 2, length / 2, n)[:, None] * d


def _scene(rng, n):
    """Matched keys as a frame has them: points in the camera's view volume
    and the same points seen from a second pose."""
    src = rng.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 3.0], size=(n, 3))
    return src, (src @ _rotation(rng).T + rng.normal(scale=0.05, size=3)
                 + rng.normal(scale=1e-3, size=(n, 3)))


def random_pairs(seed, P, r_cap=R_RAW):
    """P pairs of seeded matches with 0 to 25 inliers anywhere in the row."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(P):
        src, tgt = _scene(rng, r_cap)
        m = np.zeros(r_cap, bool)
        m[rng.permutation(r_cap)[:rng.integers(0, 26)]] = True
        pairs.append((src.astype(np.float32), tgt.astype(np.float32), m))
    return _batch(*pairs)


def case_random():
    def check(out):
        keep, a0, a1 = out
        assert np.isfinite(a0).all() and np.isfinite(a1).all()
        assert keep.any() and not keep.all()
    return random_pairs(0, 24), check


def case_all_zero_mask():
    rng = np.random.default_rng(1)
    src, tgt = _scene(rng, 40)
    arrays = _batch(_pair(src, tgt, 0))

    def check(out):
        keep, a0, a1 = out
        assert not keep.any() and (a0 == 0).all() and (a1 == 0).all()
    return arrays, check


def case_one_to_three_inliers():
    rng = np.random.default_rng(2)
    pairs = []
    for n in (1, 2, 3):
        src, tgt = _scene(rng, n)
        pairs.append(_pair(src, tgt))

    def check(out):
        keep, a0, a1 = out
        # one point or two span no area; three span a triangle's box
        assert (a0[:2] == 0).all() and (a1[:2] == 0).all() and not keep[:2].any()
        assert a0[2] > 0 and a1[2] > 0
    return _batch(*pairs), check


def case_collinear_and_coplanar():
    rng = np.random.default_rng(3)
    line = _line(rng, 25)
    plane = _placed(rng, _rect(0.4, 0.25) + np.c_[rng.uniform(-0.1, 0.1, (25, 2)), np.zeros(25)])
    pairs = [_pair(line, line + 0.01), _pair(plane, plane), _pair(line, plane)]

    def check(out):
        keep, a0, a1 = out
        assert a0[0] == 0 and a1[0] == 0 and not keep[0]        # a line spans no area
        assert a0[1] > THRESH and a1[1] > THRESH and keep[1]   # a plane keeps its own
        assert a0[2] == 0 and a1[2] == a0[1] and keep[2]       # one image decides
    return _batch(*pairs), check


def case_duplicates():
    rng = np.random.default_rng(4)
    src, tgt = _scene(rng, 10)
    dup = np.concatenate([src, src[:3], src[:3]])
    dup_t = np.concatenate([tgt, tgt[:3], tgt[:3]])
    same = np.repeat(src[:1], 8, 0)
    pairs = [_pair(dup, dup_t), _pair(same, same)]

    def check(out):
        keep, a0, a1 = out
        assert a0[0] > 0 and a0[1] == 0 and a1[1] == 0 and not keep[1]
    return _batch(*pairs), check


def case_nan_inf():
    """Non-finite inlier points weigh nothing: the area is the one without
    them (pair 0 against pair 1, whose mask leaves them out)."""
    rng = np.random.default_rng(5)
    src, tgt = _scene(rng, 20)
    bad = src.copy()
    bad[3] = np.nan
    bad[7, 1] = np.inf
    bad[11, 2] = -np.inf
    a = _pair(bad, tgt)
    b = _pair(bad, tgt)
    b[2][[3, 7, 11]] = False
    all_bad = _pair(np.full((6, 3), np.nan), tgt[:6])

    def check(out):
        keep, a0, a1 = out
        assert np.isfinite(a0).all() and np.isfinite(a1).all()
        assert a0[0] == a0[1] > 0
        assert a0[2] == 0 and keep[2] == (a1[2] >= THRESH)
    return _batch(a, b, all_bad), check


NEAR = (5e-5, 2e-5, -2e-5, -5e-5)   # offsets of the areas from the threshold


def case_near_threshold():
    """Planar a x b grids whose box area is THRESH + d: the source decides
    keep (its target is a line)."""
    rng = np.random.default_rng(6)
    pairs = []
    for d in NEAR:
        a = 0.2
        grid = _placed(rng, _rect(a, (THRESH + d) / a))
        pairs.append(_pair(grid, _line(rng, 25)))

    def check(out):
        keep, a0, a1 = out
        np.testing.assert_allclose(a0, THRESH + np.array(NEAR), rtol=0, atol=1e-6)
        assert (a1 == 0).all()
        np.testing.assert_array_equal(keep, np.array(NEAR) > 0)
    return _batch(*pairs), check


def case_equal_eigenvalues():
    """Ill-posed on purpose: cube corners (an isotropic covariance: no
    plane) and a square grid (a round 2x2 covariance: no box axes)."""
    rng = np.random.default_rng(7)
    cube = _placed(rng, np.array([[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1)
                                  for z in (-0.1, 0.1)]))
    square = _placed(rng, _rect(0.3, 0.3))

    def check(out):
        keep, a0, a1 = out
        assert np.isfinite(a0).all() and np.isfinite(a1).all() and (a0 > 0).all()
    return _batch(_pair(cube, cube), _pair(square, square)), check


CASES = {
    "random": case_random,
    "all_zero_mask": case_all_zero_mask,
    "one_to_three_inliers": case_one_to_three_inliers,
    "collinear_and_coplanar": case_collinear_and_coplanar,
    "duplicates": case_duplicates,
    "nan_inf": case_nan_inf,
    "near_threshold": case_near_threshold,
    "equal_eigenvalues": case_equal_eigenvalues,
}


def ill_posed(pts, mask):
    """[P] bool: whether one image's area is ill-posed (see the module
    docstring), from its points and mask in float64."""
    out = np.zeros(len(pts), bool)
    for p, (x, m) in enumerate(zip(pts.astype(np.float64), mask)):
        w = m & np.isfinite(x).all(-1)
        if w.sum() < 2:
            continue
        y = x[w]
        c = y - y.mean(0)
        lam, vec = np.linalg.eigh(c.T @ c / len(y))
        if lam[2] <= 0:
            continue
        if lam[1] - lam[0] < GAP_RTOL * lam[2]:
            out[p] = True
            continue
        q = c @ vec[:, [2, 1]]
        mu = np.linalg.eigvalsh(q.T @ q / len(y))
        out[p] = mu[1] - mu[0] < GAP_RTOL * mu[1]
    return out


def compare(got, want, arrays):
    """Hold ``got`` = (keep, a0, a1) to ``want`` where the reference is
    well-posed: areas within AREA_ATOL or AREA_RTOL, and keep flags equal
    unless an ill-posed image's area reaches the threshold in either.
    Returns the number of images skipped as ill-posed."""
    src, tgt, mask = arrays
    skips = (ill_posed(src, mask), ill_posed(tgt, mask))
    undecided = np.zeros(len(mask), bool)
    for g, w, skip in zip(got[1:], want[1:], skips):
        err = np.abs(g - w)
        ok = (err <= AREA_ATOL) | (err <= AREA_RTOL * np.abs(w)) | skip
        assert ok.all(), (np.flatnonzero(~ok), g[~ok], w[~ok])
        undecided |= skip & ((g >= THRESH) | (w >= THRESH))
    np.testing.assert_array_equal(got[0][~undecided], want[0][~undecided])
    return int(skips[0].sum() + skips[1].sum())
