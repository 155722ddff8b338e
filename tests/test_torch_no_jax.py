"""The port stands alone: importing it loads neither JAX nor the JAX package
(nor ``cv2``, which only the JPEG / PNG and image-writing paths import, where
they are used), and ``chip_smoke.py`` refuses to run without a CUDA card."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bundlefusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bundlefusion_tpu", "cv2"))
print(len(names), bad)
missing = [m for m in EXPECTED if "bundlefusion_tpu_torch." + m not in names]
assert not missing, missing
"""

# every module the port holds: a new one is added here with its port
MODULES = [
    "__main__", "bench", "config", "kernels",
    "geometry.camera", "geometry.kabsch", "geometry.lie",
    "io.binary_dump", "io.checkpoint", "io.native", "io.ply", "io.sens", "io.sensors",
    "io.synthetic", "io.tum",
    "ops.filters", "ops.image", "ops.matching", "ops.resample", "ops.sift",
    "parallel.ba_sharded", "parallel.map_sharded", "parallel.mesh",
    "pipeline.frames", "pipeline.frontend", "pipeline.online", "pipeline.trajectory",
    "scripts", "scripts.ablate", "scripts.common", "scripts.drift_capacity",
    "scripts.drift_demo", "scripts.fidelity_report", "scripts.make_fixture",
    "scripts.profile_boundary", "scripts.scale_run", "scripts.scaling_harness",
    "scripts.seq_cache", "scripts.verify_drive",
    "solver.dense_term", "solver.gn_pcg", "solver.residuals",
    "tsdf.apply_ops", "tsdf.integrate", "tsdf.marching_cubes", "tsdf.raycast", "tsdf.splat",
    "tsdf.streaming", "tsdf.table",
    "utils.corr_eval", "utils.metrics", "utils.timing", "utils.visualization",
]


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_port_never_imports_jax():
    out = _run(["-c", f"EXPECTED = {MODULES!r}\n" + _IMPORT_ALL])
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= len(MODULES)
    assert bad.strip() == "[]", bad


def test_port_sources_name_no_jax_import():
    """No source line of the port or of chip_smoke.py imports JAX or the
    JAX package, not even inside a function that the walk above never
    calls."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|bundlefusion_tpu)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "bundlefusion_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > len(MODULES)
    for path in files:
        with open(path) as fh:
            hits = [line for line in fh if pat.match(line)]
        assert not hits, (path, hits)


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run the slice")
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert out.stdout == ""
