"""The port's scripts (``bundlefusion_tpu_torch.scripts``) against the
JAX package, on the CPU.

- ``seq_cache``: a shard of a sequence is the same frames of the whole
  render, bit for bit, and agrees with the JAX ``make_sequence_wire`` of the
  same trajectory, noise, blackout and seed within the tolerances of
  ``tests/test_torch_synthetic.py``;
- ``profile_boundary``: its problem copies the JAX script's draws, and the
  boundary's calls (``presort_corrs``, ``solve_sparse_presorted``,
  ``max_residual_sorted``, a prune round through ``invalidate_pair_sorted``)
  give what the JAX functions give on the same store: in the exact case, in
  the window below the store's capacity, and past the working-set cap, the
  pair cap, or both (the same ``dropped``, working set and worst pair;
  poses within 1e-4);
- every cheap script run with ``--out`` writes there and nowhere else in
  the checkout (the engine runs: ``tests/test_torch_scripts_{drift,ablate,runs}.py``).

The JAX scripts themselves are never run: they write into the repo root.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from bundlefusion_tpu.io import synthetic as jsyn
from bundlefusion_tpu.solver import gn_pcg as jgn
from bundlefusion_tpu.solver.residuals import CorrStore as JaxCorrStore
from bundlefusion_tpu_torch.scripts import profile_boundary, seq_cache
from tests.torch_scripts_util import ROOT, outside_writes, snapshot

MAX_MASK_DIFF = 1e-3   # tests/test_torch_synthetic.py
POSE_ATOL = 1e-4
G, PER_PAIR = 32, 8    # 143 pairs, 1 144 rows


def test_shard_equals_the_frames_of_a_full_render(tmp_path):
    kw = dict(traj="multiloop", blackout=(5, 9))
    full = seq_cache.render_shard(12, 80, 60, full_n=12, **kw)
    shard = seq_cache.cached(5, 80, 60, start=4, full_n=12, cache_dir=str(tmp_path), **kw)
    for k in ("depth", "color", "poses"):
        np.testing.assert_array_equal(shard[k], full[k][4:9])
    assert not shard["depth"][1:].any() and shard["depth"][0].any()   # frames 5-8 dark
    again = seq_cache.cached(5, 80, 60, start=4, full_n=12, cache_dir=str(tmp_path), **kw)
    for k in ("depth", "color", "poses"):
        np.testing.assert_array_equal(again[k], shard[k])
    assert os.listdir(tmp_path) == [os.path.basename(seq_cache.cache_path(
        str(tmp_path), 5, 80, 60, start=4, full_n=12, **kw))]


@pytest.mark.parametrize("start", [0, 3])
def test_shard_matches_jax_wire_render(start):
    n, full_n, noise, blackout, seed = 5, 9, 0.005, (4, 6), 2
    t = seq_cache.render_shard(n, 80, 60, "loop", noise, blackout, seed, start, full_n)
    # the JAX render of the same frames, as scripts/render_seq.py sets it up
    a, b = max(blackout[0] - start, 0), min(blackout[1] - start, n)
    j = jsyn.make_sequence_wire(n, intr=jsyn.default_intrinsics(80, 60),
                                poses=jsyn.loop_trajectory(full_n)[start:start + n],
                                noise_depth=noise, blackout=(a, b), seed=seed + start)
    np.testing.assert_array_equal(t["poses"], j["poses"])
    jd, td = j["depth"].astype(np.int64), t["depth"].astype(np.int64)
    assert ((jd > 0) != (td > 0)).mean() <= MAX_MASK_DIFF
    both = (jd > 0) & (td > 0)
    # float depth within 1e-4 m (times the noise factor) can round to the
    # neighbouring mm code
    assert np.abs(jd - td)[both].max() <= 1
    assert np.abs(j["color"].astype(int) - t["color"].astype(int))[both].max() <= 1
    dark = [f for f in range(n) if not t["depth"][f].any()]
    assert dark == [f for f in range(n) if not j["depth"][f].any()] == list(range(a, b))


OUTLIER_PAIR = 100     # a loop closure whose rows are moved 5 cm: the worst pair


@pytest.fixture(scope="module")
def problem():
    return profile_boundary.build_problem(G, PER_PAIR, np.random.default_rng(0))


@pytest.fixture(scope="module")
def problem_outlier(problem):
    arr = {k: np.array(v) for k, v in problem["arrays"].items()}
    rows = slice(OUTLIER_PAIR * PER_PAIR, (OUTLIER_PAIR + 1) * PER_PAIR)
    arr["p_j"][rows] += np.float32(0.05)
    pair = [int(arr["img_i"][rows][0]), int(arr["img_j"][rows][0])]
    return {**problem, "arrays": arr, "outlier": pair}


def test_problem_copies_the_jax_scripts_draws(problem):
    spec = importlib.util.spec_from_file_location(
        "jax_profile_boundary", os.path.join(ROOT, "scripts", "profile_boundary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)          # defines functions; main() is not run
    init, store, n_pairs, n_corrs = mod.build_problem(G, PER_PAIR, np.random.default_rng(0))
    assert (n_pairs, n_corrs) == (problem["pairs"], problem["corrs"])
    assert store.capacity == problem["capacity"] == 1 << 18
    np.testing.assert_array_equal(np.asarray(init), problem["init"])
    arr = problem["arrays"]
    assert int(store.count) == int(arr["count"]) == n_corrs
    for k in ("img_i", "img_j"):
        np.testing.assert_array_equal(np.asarray(getattr(store, k)), arr[k])
    for k in ("p_i", "p_j"):
        np.testing.assert_allclose(np.asarray(getattr(store, k)), arr[k], rtol=0, atol=1e-5)


def _jax_calls(problem, params):
    store = JaxCorrStore(**{k: jnp.asarray(v) for k, v in problem["arrays"].items()})
    poses = jnp.asarray(problem["init"])
    kv = jnp.ones((G,), bool)
    jp = jgn.SolverParams(num_gn=params.num_gn, num_pcg=params.num_pcg,
                          max_pairs=params.max_pairs,
                          max_working_corrs=params.max_working_corrs)
    prob = jgn.presort_corrs(store, G, jp)
    sposes = jgn.solve_sparse_presorted(poses, kv, prob, jp)
    mr, fa, fb = jgn.max_residual_sorted(sposes, prob)
    pruned = jgn.solve_sparse_presorted(poses, kv, jgn.invalidate_pair_sorted(prob, fa, fb), jp)
    sc = prob.sc
    return {"dropped": int(sc.dropped), "working_img_i": np.asarray(sc.img_i),
            "working_img_j": np.asarray(sc.img_j), "working_valid": np.asarray(sc.valid),
            "poses": np.asarray(sposes), "poses_after_prune": np.asarray(pruned),
            "worst_pair": [int(fa), int(fb)], "max_residual": float(mr)}


# (max_pairs, max_working_corrs): exact; a window of the store's first rows
# (the cursor below it); past the working-set cap; past the pair cap; both
REGIMES = {"exact": (1 << 18, 1 << 22), "window": (1 << 18, 2048),
           "working_overflow": (1 << 18, 512), "pair_overflow": (100, 1 << 22),
           "both_overflow": (100, 512)}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_boundary_calls_match_jax(problem_outlier, regime):
    import torch

    problem = problem_outlier
    params = profile_boundary.solver_params(*REGIMES[regime])
    t = profile_boundary.boundary_calls(problem, params, torch.device("cpu"))
    j = _jax_calls(problem, params)
    assert t["times"] == dict.fromkeys(t["times"])        # no time taken on the CPU
    assert t["dropped"] == j["dropped"]
    assert (t["dropped"] > 0) == (regime not in ("exact", "window"))
    for k in ("working_img_i", "working_img_j", "working_valid"):
        np.testing.assert_array_equal(t[k], j[k])
    assert t["worst_pair"] == j["worst_pair"] == problem["outlier"]
    assert abs(t["max_residual"] - j["max_residual"]) <= POSE_ATOL
    for k in ("poses", "poses_after_prune"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=POSE_ATOL)
    assert t["cost_final"] < t["cost_initial"]


def test_noise_free_problem_solves_exactly(problem):
    import torch

    t = profile_boundary.boundary_calls(problem, profile_boundary.solver_params(),
                                        torch.device("cpu"))
    assert t["dropped"] == 0 and t["max_residual"] < 1e-5
    assert t["cost_final"] < 1e-6 * t["cost_initial"]
    np.testing.assert_allclose(t["poses"], problem["gt"], rtol=0, atol=1e-5)


CHEAP = {
    "seq_cache": ["6", "80", "60", "--traj", "loop", "--blackout", "2", "4"],
    "profile_boundary": [str(G), str(PER_PAIR)],
    "make_fixture": [],
    "verify_drive": [],
    "fidelity_report": [],
}
WRITES = {"seq_cache": None, "profile_boundary": ["profile_boundary.json"],
          "make_fixture": ["tiny.sens"], "verify_drive": ["verify_drive.json"],
          "fidelity_report": ["fidelity_report.csv", "fidelity_report.json"]}


@pytest.mark.parametrize("name", list(CHEAP))
def test_script_writes_only_under_out(name, tmp_path):
    mod = importlib.import_module(f"bundlefusion_tpu_torch.scripts.{name}")
    out_dir = tmp_path / "out"
    before = snapshot()
    res = mod.main(CHEAP[name] + ["--device", "cpu", "--out", str(out_dir)])
    assert outside_writes(before) == []
    json.dumps(res)
    names = sorted(os.listdir(out_dir))
    if WRITES[name] is None:          # the cache file of the shard
        assert names == [os.path.basename(res["path"])] and res["frames"] == 6
    else:
        assert names == WRITES[name]
    if name == "make_fixture":
        from bundlefusion_tpu_torch.io.sens import load_sens

        data = load_sens(str(out_dir / "tiny.sens"))
        ref = load_sens(os.path.join(ROOT, "tests", "fixtures", "tiny.sens"))
        assert len(data.frames) == len(ref.frames) == 12
        assert (data.color_width, data.color_height) == (ref.color_width, ref.color_height)
        for a, b in zip(data.frames, ref.frames):
            np.testing.assert_allclose(a.camera_to_world, b.camera_to_world, atol=1e-6)
