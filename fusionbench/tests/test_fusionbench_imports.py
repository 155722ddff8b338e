"""The harness imports no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``bundlefusion_tpu`` (names compared whole: the
port's ``bundlefusion_tpu_torch`` begins with the last), and its reference
imports nothing of the program; without a card the command refuses."""

import os
import subprocess
import sys

from fusionbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "bundlefusion_tpu"}


def _python(code, **kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_harness_loads_no_jax():
    code = """
import sys, os, glob, importlib
from fusionbench import run, system, scan, check, reference, window, trace, control
import bundlefusion_tpu_torch.pipeline.online
for f in glob.glob("fusionbench/metrics/*.py"):
    run.load_reader(os.path.basename(f)[:-3])
print(sorted({m.split(".")[0] for m in sys.modules}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "bundlefusion_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_forbidden_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["bundlefusion_tpu_torch_x"] = sys
        assert "bundlefusion_tpu" not in run.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    out = _python("import sys\nfrom fusionbench import reference, check, scan, control\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr
    assert "bundlefusion_tpu_torch" not in out.stdout


def test_without_a_card_the_command_refuses():
    out = _python("import runpy, sys\nsys.argv = ['fusionbench', '--workload', 'default.offline', "
                  "'--seed', '1', '--seconds', '1', '--trace', '0']\n"
                  "import torch\nif torch.cuda.is_available():\n    sys.exit(0)\n"
                  "runpy.run_module('fusionbench', run_name='__main__')")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
