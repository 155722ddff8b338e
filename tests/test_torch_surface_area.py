"""The surface-area filter's plain version against the JAX package on its
edge cases, and how the port dispatches it.

``surface_area_filter_ref`` (the torch-op version that runs on the CPU, and
that ``tests/test_torch_cuda.py`` holds ``kernels/surface_area.cu`` against
on the card) is held to the JAX ``surface_area_filter`` on the seeded cases
of ``tests/torch_surface_area_cases.py``: an all-zero mask, 1-3 inliers,
collinear and coplanar points, duplicates, NaN / inf points, areas within
5e-5 of the 0.032 threshold and equal eigenvalues, plus random pairs at the
per-frame and global widths. Areas agree to 1e-5 absolute or 1e-4 relative
and keep flags are equal; where the reference is ill-posed (a relative
eigengap under 1e-3: the plane or the box's axes are not defined by the
points), either answer is accepted and only each case's own checks apply.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.ops import filters as jf
from bundlefusion_tpu_torch import kernels
from bundlefusion_tpu_torch.ops import filters as tf
from tests.torch_parity import t, to_np
from tests.torch_surface_area_cases import CASES, THRESH, compare, random_pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(arrays):
    return tuple(to_np(x) for x in jf.surface_area_filter(*(jnp.asarray(a) for a in arrays),
                                                          THRESH))


def _plain(arrays):
    return tuple(x.numpy() for x in tf.surface_area_filter_ref(*(t(a) for a in arrays), THRESH))


@pytest.mark.parametrize("case", list(CASES))
def test_edge_case_matches_jax(case):
    arrays, check = CASES[case]()
    got, want = _plain(arrays), _jax(arrays)
    check(got)
    check(want)
    compare(got, want, arrays)


@pytest.mark.parametrize("pairs", [10, 64, 640])
def test_random_pairs_match_jax(pairs):
    """One frame's call (10 pairs) and two global matches' widths."""
    arrays = random_pairs(pairs, pairs)
    got = _plain(arrays)
    compare(got, _jax(arrays), arrays)
    assert got[0].any()


def test_cpu_dispatch_runs_the_plain_version():
    arrays, _ = CASES["random"]()
    got = tf.surface_area_filter(*(t(a) for a in arrays), THRESH)
    want = tf.surface_area_filter_ref(*(t(a) for a in arrays), THRESH)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    one = tf.surface_area_filter_pair(*(t(a[2]) for a in arrays), THRESH)
    for g, w in zip(one, want):
        assert torch.equal(g, w[2])


def test_launcher_refuses_host_tensors():
    src, tgt, mask = (t(a) for a in CASES["random"]()[0])
    with pytest.raises(ValueError):
        kernels.surface_area_launch(src, tgt, mask, THRESH)


def test_kernel_source_is_registered():
    assert kernels.SOURCES["surface_area"] == "surface_area.cu"
    assert "surface_area" in kernels.launch_counts
    src = open(os.path.join(kernels.KERNEL_DIR, "surface_area.cu")).read()
    assert 'extern "C" int bf_surface_area(' in src
    assert "bundlefusion_tpu/ops/filters.py:234-280" in src


def test_importing_the_filters_builds_nothing():
    """The wrapper loads the kernel only when it launches it: importing the
    filters (and every module that imports them) compiles and loads
    nothing, so the CPU has no need of nvcc."""
    code = ("import bundlefusion_tpu_torch.pipeline.online, bundlefusion_tpu_torch.kernels as k;"
            "assert not k._libs and not k.build_logs")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)
