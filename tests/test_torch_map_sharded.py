"""The port's TSDF map sharding (``parallel/map_sharded``) on 2 ``gloo``
ranks on the CPU, against the JAX module's single-device XLA sweep and the
port's plain sweep, at the inputs of ``tests/test_map_sharded.py``.

Each rank applies the op batch to its half of the payload rows (the plain
row core on the CPU); the halves are gathered back into the whole table.
Rows are independent given their block key, so the gathered payload equals
the port's plain full sweep bit for bit, and the JAX XLA sweep with the
weights equal and sdf / colour within 1e-6 (the tolerance of
``tests/test_torch_apply_ops.py``: float32 rounding of the division). An
integrate followed by a de-integrate of the same frame returns every weight
to 0 exactly. One spawn of 2 ranks runs both scenarios.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.tsdf.apply_pallas import apply_tsdf_ops_xla
from bundlefusion_tpu.tsdf.integrate import TsdfParams, candidate_keys
from bundlefusion_tpu.tsdf.table import allocate_packed, create_table
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.parallel.mesh import run_ranks
from bundlefusion_tpu_torch.tsdf import apply_ops
from bundlefusion_tpu_torch.tsdf import integrate as tint
from bundlefusion_tpu_torch.tsdf.table import table_from_numpy
from tests.torch_mesh_workers import map_scenarios
from tests.torch_parity import fields_np

ATOL = 1e-6
N_RANKS = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    intr = default_intrinsics(80, 60)
    params = TsdfParams(voxel_size=0.04, truncation=0.12)
    seq = make_sequence(3, intr=intr)
    depths = np.asarray(seq["depth"][:2])
    colors = np.asarray(seq["color"][:2])
    poses = np.asarray(seq["poses"][:2]).astype(np.float32)
    table = create_table(4096, 2048)
    # allocation on the replicated index (single-writer semantics)
    for i in range(2):
        table = allocate_packed(table, candidate_keys(jnp.asarray(depths[i]), intr,
                                                      jnp.asarray(poses[i]), params))
    arrays = fields_np(table)
    ranks = run_ranks(map_scenarios, N_RANKS, arrays, depths, colors, poses,
                      dataclasses.asdict(intr), dataclasses.asdict(params), device="cpu",
                      init_method="file://" + str(tmp_path_factory.mktemp("rdzv") / "store"))
    return intr, params, table, arrays, depths, colors, poses, ranks


def _port_plain(arrays, intr, params, depths, colors, poses, signs, imgs):
    t = table_from_numpy(arrays, "cpu")
    apply_ops.apply_tsdf_ops_ref(t, torch.from_numpy(depths), torch.from_numpy(colors),
                                 torch.from_numpy(poses), signs, imgs,
                                 CameraIntrinsics(**dataclasses.asdict(intr)),
                                 tint.TsdfParams(**dataclasses.asdict(params)))
    return {"sdf": t.sdf.numpy(), "weight": t.weight.numpy(), "color": t.color.numpy()}


def test_each_rank_holds_half_the_rows(setup):
    *_, arrays, _, _, _, ranks = setup
    n = arrays["sdf"].shape[0] - 1
    assert all(r["shard_rows"] == n // N_RANKS for r in ranks)
    # on the CPU the plain row core runs: no kernel was launched
    assert all(not any(r["launches"].values()) for r in ranks)


def test_sharded_integrate_equals_plain_sweep(setup):
    intr, params, _, arrays, depths, colors, poses, ranks = setup
    ref = _port_plain(arrays, intr, params, depths, colors, poses, [1.0, 1.0], [0, 1])
    assert ref["weight"].sum() > 0  # something integrated
    for r in ranks:
        for name in ("sdf", "weight", "color"):
            np.testing.assert_array_equal(r["integrated"][name], ref[name])


def test_sharded_integrate_matches_jax_xla(setup):
    intr, params, table, _, depths, colors, poses, ranks = setup
    ref = apply_tsdf_ops_xla(table, jnp.asarray(depths), jnp.asarray(colors),
                             jnp.asarray(poses), jnp.asarray([1.0, 1.0], jnp.float32),
                             jnp.asarray([0, 1], jnp.int32), intr, params)
    for r in ranks:
        out = r["integrated"]
        np.testing.assert_array_equal(out["weight"], np.asarray(ref.weight))
        np.testing.assert_allclose(out["sdf"], np.asarray(ref.sdf), rtol=0, atol=ATOL)
        np.testing.assert_allclose(out["color"], np.asarray(ref.color), rtol=0, atol=ATOL)


def test_sharded_deintegrate_round_trip(setup):
    *_, arrays, _, _, _, ranks = setup
    for r in ranks:
        assert r["once"]["weight"].sum() > 0
        np.testing.assert_array_equal(r["round_trip"]["weight"], arrays["weight"])
