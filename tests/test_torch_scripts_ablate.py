"""``bundlefusion_tpu_torch.scripts.ablate`` at its CPU size: the JAX
script's output keys, the switches (``no_solve`` and ``frontend_only``
dispatch no boundary, ``no_tsdf`` no TSDF op), and its JSON written under
``--out`` and nowhere else in the checkout.

The JAX ``scripts/ablate.py`` is not run (it writes into the repo root):
its committed output ``ABLATION.json`` gives the keys.
"""

import json
import os

import pytest

from bundlefusion_tpu_torch.scripts import ablate
from tests.torch_scripts_util import ROOT, outside_writes, snapshot


@pytest.fixture(scope="module")
def ablation(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("ablate")
    before = snapshot()
    out = ablate.main(["--device", "cpu", "--out", str(out_dir)])
    return out, outside_writes(before), out_dir


def test_ablation_keys_equal_the_jax_scripts(ablation):
    out, _, _ = ablation
    with open(os.path.join(ROOT, "ABLATION.json")) as fh:
        ref = json.load(fh)
    assert set(out) == set(ref)
    for name in ablate.CONFIGS:
        assert set(out[name]) == set(ref[name]), name
        assert out[name]["ms_per_frame"] > 0
    assert set(out["attribution_ms"]) == set(ref["attribution_ms"])
    assert {"platform", "ms_full"} <= set(out["_meta"]) and out["_meta"]["platform"] == "cpu"


def test_ablation_switches(ablation):
    out, _, _ = ablation
    boundaries = out["_meta"]["boundaries"]
    # 13 frames at submaps of 4: boundaries at frames 4, 8 and 12
    assert boundaries["full"] == boundaries["no_render"] == boundaries["no_tsdf"] == 3
    assert boundaries["no_solve"] == boundaries["frontend_only"] == 0
    assert out["no_tsdf"]["reint_frames"] == out["frontend_only"]["reint_frames"] == 0
    assert out["no_solve"]["reint_ops"] == 0      # no boundary, no pose update to re-integrate
    assert out["full"]["reint_frames"] > 0
    assert out["attribution_ms"]["frontend_floor"] == out["frontend_only"]["ms_per_frame"]


def test_ablation_writes_only_under_out(ablation):
    out, outside, out_dir = ablation
    assert outside == []
    assert os.listdir(out_dir) == ["ablate.json"]
    with open(out_dir / "ablate.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(out))
