"""The port's correspondence evaluator (``utils/corr_eval``) against the JAX
package's, on the CPU.

- ``StageStats`` on the hand-made case of ``tests/test_corr_eval.py``, exact;
- the cascade on ``make_sequence(6)`` (adjacent pairs, with the dense cache,
  so all four stages and the dense-verify sweep rows run) against the JAX
  ``evaluate_frontend_fidelity``: the raw-match counts per pair equal, each
  stage's tp / fp / fn within 2 % (the bound of ``tests/test_torch_sift.py``
  for keys that round across a bin edge in one package and not the other),
  the dense-verify rows the same pairs, perturbations and labels with
  ``err`` / ``corr`` within 1e-4 relative (float32 sums in another order),
  and the JAX test's absolute bounds.
"""

import dataclasses

import numpy as np
import pytest

from bundlefusion_tpu import BundlingConfig
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops.filters import DenseVerifyParams
from bundlefusion_tpu.ops.sift import SiftConfig
from bundlefusion_tpu.pipeline.frontend import FrontendParams
from bundlefusion_tpu.utils.corr_eval import evaluate_frontend_fidelity as jax_eval
import bundlefusion_tpu_torch as port
from bundlefusion_tpu_torch.ops.filters import DenseVerifyParams as TorchDenseParams
from bundlefusion_tpu_torch.pipeline.frontend import FrontendParams as TorchFrontendParams
from bundlefusion_tpu_torch.utils.corr_eval import (
    CorrespondenceEvaluator,
    evaluate_frontend_fidelity,
)
from tests.torch_parity import SIFT

COUNT_RTOL = 0.02
DENSE_RTOL = 1e-4


def test_stage_stats_math():
    gt = np.stack([np.eye(4, dtype=np.float32)] * 2)
    ev = CorrespondenceEvaluator(gt, dist_thresh=0.05)
    p = np.array([[0, 0, 1.0], [0, 0, 1.0], [0, 0, 1.0]], np.float32)
    q = p.copy()
    q[1] += 0.5  # wrong match
    cand = np.array([True, True, True])
    kept = np.array([True, True, False])
    ev.record_stage("s", 1, 0, p, q, cand, kept)
    s = ev.summary()["s"]
    assert s["tp"] == 1 and s["fp"] == 1 and s["fn"] == 1
    assert s["precision"] == 0.5 and s["recall"] == 0.5
    assert ev.rows == [{"stage": "s", "i": 1, "j": 0, "n_in": 3, "n_out": 2,
                        "n_correct_in": 2, "n_correct_out": 1}]


@pytest.fixture(scope="module")
def both():
    intr = default_intrinsics(160, 120)
    b = BundlingConfig()
    fp = dict(
        sift_match_thresh=b.sift_match_thresh,
        sift_match_ratio=b.sift_match_ratio_max_local,
        num_raw_matches=b.max_matches_per_image_pair_raw,
        max_filtered=b.max_matches_per_image_pair_filtered,
        min_num_matches=4,
        max_kabsch_res2=b.max_kabsch_residual2,
        surf_area_thresh=b.surf_area_pca_thresh,
    )
    seq = {k: np.asarray(v) for k, v in make_sequence(6, intr=intr).items()
           if k in ("depth", "color", "poses")}
    jev, js = jax_eval(seq, intr, SiftConfig(**SIFT),
                       FrontendParams(**fp, dense=DenseVerifyParams()),
                       intr_cache=intr.scaled(40, 30), pair_stride=(1,))
    tintr = port.CameraIntrinsics(**dataclasses.asdict(intr))
    tev, ts = evaluate_frontend_fidelity(
        seq, tintr, port.SiftConfig(**SIFT),
        TorchFrontendParams(**fp, dense=TorchDenseParams()),
        intr_cache=tintr.scaled(40, 30), pair_stride=(1,), device="cpu")
    return jev, js, tev, ts


def test_raw_match_counts_equal(both):
    jev, _, tev, _ = both

    def raw(ev):
        return [(r["i"], r["j"], r["n_in"]) for r in ev.rows if r["stage"] == "0_raw_match"]

    assert raw(tev) == raw(jev)
    assert len(raw(tev)) == 5


def test_stage_counts_within_two_percent(both):
    _, js, _, ts = both
    assert list(ts) == list(js) == ["0_raw_match", "1_kabsch", "2_surface_area",
                                    "3_dense_verify"]
    for stage in js:
        for k in ("tp", "fp", "fn"):
            assert abs(ts[stage][k] - js[stage][k]) <= COUNT_RTOL * max(js[stage][k], 1), (
                stage, k, ts[stage][k], js[stage][k])


def test_dense_verify_rows_match(both):
    jev, _, tev, _ = both
    assert len(tev.dense_rows) == len(jev.dense_rows) == 5 * 6
    for t, j in zip(tev.dense_rows, jev.dense_rows):
        for k in ("i", "j", "n_in", "good", "perturb_m"):
            assert t[k] == j[k], (k, t, j)
        np.testing.assert_allclose([t["err"], t["corr"]], [j["err"], j["corr"]],
                                   rtol=DENSE_RTOL)


def test_absolute_bounds_of_the_jax_test(both):
    _, _, _, ts = both
    assert ts["0_raw_match"]["tp"] > 50
    assert ts["1_kabsch"]["precision"] >= ts["0_raw_match"]["precision"]
    assert ts["1_kabsch"]["precision"] > 0.95
    assert ts["1_kabsch"]["recall"] > 0.6


def test_csv_export(both, tmp_path):
    _, _, tev, _ = both
    path = tmp_path / "stages.csv"
    tev.to_csv(str(path))
    lines = path.read_text().splitlines()
    assert lines[0] == "stage,i,j,n_in,n_out,n_correct_in,n_correct_out"
    assert len(lines) == 1 + len(tev.rows) == 1 + 4 * 5
