"""The greedy Kabsch filter's plain version against the JAX package on its
edge cases, and how the port dispatches it.

``kabsch_filter_ref`` (the torch-op version that runs on the CPU, and that
``tests/test_torch_cuda.py`` holds ``kernels/kabsch_filter.cu`` against on
the card) is held to the JAX ``kabsch_filter`` on seeded inputs: masks,
counts and ``valid_pair`` equal, transforms within 1e-4 (the tolerance of
``tests/test_torch_filters.py``). The cases are the ones where the two loops
take their rare branches: fewer than 3 valid matches, no valid match, a
strip that reverts at 3, a tie for the worst residual, a pair that fills
``max_filtered``, and no pair at all.
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
from tests.torch_kabsch_cases import CASES, MAX_FILTERED, MAX_RES2, MIN_MATCHES, T_ATOL
from tests.torch_parity import t, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(arrays):
    out = jf.kabsch_filter(*(jnp.asarray(a) for a in arrays), MAX_FILTERED, MIN_MATCHES,
                           MAX_RES2)
    return {k: to_np(v) for k, v in out.items()}


def assert_matches(got, want):
    np.testing.assert_array_equal(got["valid_pair"].numpy(), want["valid_pair"])
    np.testing.assert_array_equal(got["inlier_mask"].numpy(), want["inlier_mask"])
    np.testing.assert_array_equal(got["count"].numpy(), want["count"])
    np.testing.assert_allclose(got["transform"].numpy(), want["transform"], rtol=0,
                               atol=T_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_edge_case_matches_jax(case):
    arrays, check = CASES[case]()
    assert (np.diff(arrays[4].astype(int), axis=1) <= 0).all()   # valid is a prefix
    got = tf.kabsch_filter_ref(*(t(a) for a in arrays), MAX_FILTERED, MIN_MATCHES, MAX_RES2)
    assert_matches(got, _jax(arrays))
    check(got)


def test_edge_cases_in_one_batch_match_jax():
    """All pairs in one call: each pair as JAX has it, whatever step the
    others stop at."""
    parts = [CASES[c]()[0] for c in CASES if c != "no_pairs"]
    arrays = tuple(np.concatenate([p[i] for p in parts]) for i in range(5))
    got = tf.kabsch_filter_ref(*(t(a) for a in arrays), MAX_FILTERED, MIN_MATCHES, MAX_RES2)
    assert_matches(got, _jax(arrays))
    assert got["valid_pair"].tolist() == [False, False, False, True, True]


def test_entry_runs_the_plain_version_on_the_cpu(monkeypatch):
    calls = []
    ref = tf.kabsch_filter_ref

    def counted(*args):
        calls.append(args[0].device)
        return ref(*args)

    def no_launch(*args, **kw):
        raise AssertionError("the kernel's launcher was called with CPU tensors")

    monkeypatch.setattr(tf, "kabsch_filter_ref", counted)
    monkeypatch.setattr(kernels, "kabsch_filter_launch", no_launch)
    before = dict(kernels.launch_counts)
    arrays = CASES["tie_for_worst"]()[0]
    got = tf.kabsch_filter(*(t(a) for a in arrays))
    one = tf.kabsch_filter_pair(*(t(a[0]) for a in arrays))
    assert calls == [torch.device("cpu")] * 2
    assert kernels.launch_counts == before
    want = ref(*(t(a) for a in arrays))
    for k in ("inlier_mask", "count", "transform", "valid_pair"):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(one[k], want[k][0]), k
    # the plain version reads the card (here: the host) once per step at least
    assert got["host_reads"] == one["host_reads"] >= int(arrays[4].sum())


def test_launcher_rejects_host_tensors():
    arrays = [t(a) for a in CASES["fewer_than_3"]()[0]]
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError):
        kernels.kabsch_filter_launch(*arrays, MAX_FILTERED, MIN_MATCHES, MAX_RES2)
    assert kernels.launch_counts == before


def test_the_kernel_source_is_registered():
    assert kernels.SOURCES["kabsch_filter"] == "kabsch_filter.cu"
    path = os.path.join(kernels.KERNEL_DIR, kernels.SOURCES["kabsch_filter"])
    assert os.path.isfile(path)
    with open(path) as fh:
        src = fh.read()
    assert 'extern "C" int bf_kabsch_filter(' in src
    assert "kabsch_filter" in kernels.launch_counts


_IMPORT_AND_FILTER = """
import importlib, pkgutil
import torch
import bundlefusion_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from bundlefusion_tpu_torch import kernels
from bundlefusion_tpu_torch.ops.filters import kabsch_filter
z = torch.zeros
out = kabsch_filter(z(2, 8, 3), z(2, 8, 3), z(2, 8, 2), z(2, 8, 2), torch.ones(2, 8, dtype=torch.bool))
assert out["valid_pair"].tolist() == [False, False]
print(sorted(kernels._libs), sorted(kernels.build_logs), sum(kernels.launch_counts.values()))
"""


def test_importing_the_port_builds_nothing():
    """Every module imported and the filter run on the CPU, with no CUDA
    toolkit to be found: no kernel library is built or loaded."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env["CUDA_HOME"] = os.path.join(ROOT, "no-cuda-toolkit-here")
    env["PATH"] = os.path.dirname(sys.executable)
    out = subprocess.run([sys.executable, "-c", _IMPORT_AND_FILTER], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] [] 0"
