"""The port's sharded bundle adjustment and matching (``parallel/ba_sharded``)
on ``gloo`` ranks on the CPU, against the JAX module on a mesh of the
virtual CPU devices and against the port's single-device solver.

The inputs are those of ``tests/test_sharded.py``: the 6-pose graph of
``tests/test_solver.build_pose_graph`` (a 2048-row store) perturbed by 0.04,
``SolverParams(num_gn=3, num_pcg=40)``, and 16 random unit descriptor sets
of 32 keys. Tolerances are that file's: poses within 2e-3 of the reference
solve, final cost under 1e-5, match indices exact. The engine's chunk solver
on the replicated store runs the same code on the same chunks as
``solve_sparse_sharded``, so the two agree bit for bit. One spawn of 2 ranks
runs every 2-rank scenario, one of 4 ranks the 4-rank solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from bundlefusion_tpu.geometry import matrix_to_pose
from bundlefusion_tpu.parallel import ba_sharded as jba
from bundlefusion_tpu.solver.gn_pcg import SolverParams as JaxParams
from bundlefusion_tpu_torch.parallel.mesh import run_ranks
from bundlefusion_tpu_torch.solver import gn_pcg as tsolver
from tests.test_solver import build_pose_graph
from tests.torch_mesh_workers import ba_scenarios, solver_scenarios
from tests.torch_parity import fields_np, port_corrs

POSE_ATOL = 2e-3
COST_MAX = 1e-5
PARAMS = dict(num_gn=3, num_pcg=40)
G_DESC, K_DESC, CUR, N_MATCH = 16, 32, 3, 16


def _rdzv(tmp_path_factory):
    return "file://" + str(tmp_path_factory.mktemp("rdzv") / "store")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    gt, store = build_pose_graph(rng)
    n = len(gt)
    gt_poses = np.stack([np.asarray(matrix_to_pose(jnp.asarray(g))) for g in gt])
    init = gt_poses.copy()
    init[1:] += rng.normal(size=(n - 1, 6)).astype(np.float32) * 0.04
    desc = rng.normal(size=(G_DESC, K_DESC, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return init.astype(np.float32), store, desc


@pytest.fixture(scope="module")
def two_ranks(problem, tmp_path_factory):
    init, store, desc = problem
    return run_ranks(ba_scenarios, 2, init, fields_np(store), PARAMS, desc, CUR, N_MATCH,
                     device="cpu", init_method=_rdzv(tmp_path_factory))


@pytest.fixture(scope="module")
def four_ranks(problem, tmp_path_factory):
    init, store, _ = problem
    return run_ranks(solver_scenarios, 4, init, fields_np(store), PARAMS, device="cpu",
                     init_method=_rdzv(tmp_path_factory))


@pytest.fixture(scope="module")
def jax_mesh_solve(problem):
    init, store, _ = problem
    mesh = jba.make_mesh(jax.devices()[:2])
    out, cost = jba.solve_sparse_sharded(jnp.asarray(init), jnp.ones(len(init), bool),
                                         jba.shard_corrs(store, mesh), mesh,
                                         JaxParams(**PARAMS))
    return np.asarray(out), float(cost)


@pytest.fixture(scope="module")
def single_device_solve(problem):
    init, store, _ = problem
    out, _ = tsolver.solve_sparse(torch.from_numpy(init), torch.ones(len(init), dtype=torch.bool),
                                  port_corrs(store), tsolver.SolverParams(**PARAMS))
    return out.numpy()


def test_sharded_solve_matches_jax_mesh(two_ranks, jax_mesh_solve):
    ref, ref_cost = jax_mesh_solve
    assert ref_cost < COST_MAX
    for r in two_ranks:
        assert r["solve"]["cost"] < COST_MAX
        np.testing.assert_allclose(r["solve"]["poses"], ref, atol=POSE_ATOL)


def test_sharded_solve_matches_single_device(two_ranks, single_device_solve):
    for r in two_ranks:
        np.testing.assert_allclose(r["solve"]["poses"], single_device_solve, atol=POSE_ATOL)


def test_ranks_hold_the_same_result(two_ranks, four_ranks):
    for ranks in (two_ranks, [{"solve": r} for r in four_ranks]):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["solve"]["poses"], ranks[0]["solve"]["poses"])
            assert r["solve"]["cost"] == ranks[0]["solve"]["cost"]


def test_chunk_solver_equals_sharded_solve(two_ranks, four_ranks):
    for r in [x["solve"] for x in two_ranks] + four_ranks:
        np.testing.assert_array_equal(r["chunk_poses"], r["poses"])


def test_four_ranks(four_ranks, single_device_solve, jax_mesh_solve):
    for r in four_ranks:
        assert r["cost"] < COST_MAX
        np.testing.assert_allclose(r["poses"], single_device_solve, atol=POSE_ATOL)
        np.testing.assert_allclose(r["poses"], jax_mesh_solve[0], atol=POSE_ATOL)


def test_no_pairs_dropped(two_ranks, four_ranks):
    assert all(r["solve"]["dropped"] == 0 for r in two_ranks)
    assert all(r["dropped"] == 0 for r in four_ranks)


def test_one_all_gather_per_gauss_newton_step(two_ranks, four_ranks):
    """Per solve: the pair structure once ([P_local, 3] int64), the
    [P_local, 156] float32 blocks once per GN step, the cost once; P_local is
    the chunk's capacity (1024 or 512 rows: under the 4096-pair budget)."""
    for ranks, n in ((two_ranks, 2), ([{"solve": r} for r in four_ranks], 4)):
        p_local = 2048 // n
        for r in ranks:
            st = r["solve"]["stats"]
            assert st["calls"] == 1 + PARAMS["num_gn"] + 1
            assert st["all_gather_bytes"] == p_local * 3 * 8 + PARAMS["num_gn"] * p_local * 156 * 4
            assert st["all_reduce_bytes"] == 4
            assert st["host_staged_bytes"] == 0  # CPU tensors under gloo


def test_sharded_matching_matches_jax(two_ranks, problem):
    _, _, desc = problem
    mesh = jba.make_mesh(jax.devices()[:2])
    sh = NamedSharding(mesh, P("shard"))
    jm = jba.match_descriptors_sharded(
        jnp.asarray(desc[CUR]), jnp.ones(K_DESC, bool),
        jax.device_put(jnp.asarray(desc), sh),
        jax.device_put(jnp.ones((G_DESC, K_DESC), bool), sh),
        jax.device_put(jnp.ones(G_DESC, bool), sh), mesh, num_matches=N_MATCH)
    for r in two_ranks:
        m = r["match"]
        np.testing.assert_array_equal(m["valid"], np.asarray(jm.valid))
        v = m["valid"]
        np.testing.assert_array_equal(m["idx_i"][v], np.asarray(jm.idx_i)[v])
        np.testing.assert_array_equal(m["idx_j"][v], np.asarray(jm.idx_j)[v])
        # the keyframe matches itself key for key
        assert v[CUR].sum() == N_MATCH
        np.testing.assert_array_equal(m["idx_i"][CUR][v[CUR]], m["idx_j"][CUR][v[CUR]])
