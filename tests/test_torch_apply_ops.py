"""Port fused TSDF op (plain versions of the image pass, the cull and the
sweep) against the JAX twin.

Setup of ``tests/test_apply_pallas.py``: 3 synthetic frames at 80x60, 4 cm
voxels. The plain full sweep matches ``apply_tsdf_ops_xla`` with weight
exact and sdf / colour within atol 1e-6 (XLA:CPU contracts the running
average into FMAs: one rounding apart). The culled path in plain PyTorch
(packed samples, row list, per-row op masks) is held to the same limits
against the full sweep and against the JAX twin. The CUDA kernels are held
against the plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.tsdf import apply_pallas as japply
from bundlefusion_tpu.tsdf import integrate as jint
from bundlefusion_tpu.tsdf import table as jtab
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.geometry.lie import pose_inverse
from bundlefusion_tpu_torch.tsdf import apply_ops
from bundlefusion_tpu_torch.tsdf import integrate as tint
from bundlefusion_tpu_torch.tsdf import table as ttab

INTR_IN = default_intrinsics(160, 120)
INTR = INTR_IN.scaled(80, 60)
TINTR = CameraIntrinsics(**INTR.__dict__)
PARAMS = jint.TsdfParams(voxel_size=0.04, truncation=0.12, max_integration_distance=4.0)
TPARAMS = tint.TsdfParams(**PARAMS.__dict__)
ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    seq = make_sequence(3, intr=INTR_IN)
    jt, tt = jtab.create_table(4096, 2048), ttab.create_table(4096, 2048, "cpu")
    D = np.ascontiguousarray(seq["depth"][:, ::2, ::2])
    C = np.ascontiguousarray(seq["color"][:, ::2, ::2])
    P = seq["poses"].astype(np.float32)
    for i in range(3):
        jt = jint.allocate_for_frame(jt, jnp.asarray(D[i]), INTR, jnp.asarray(P[i]), PARAMS)
        tt = tint.allocate_for_frame(tt, torch.from_numpy(D[i]), TINTR, torch.from_numpy(P[i]),
                                     TPARAMS)
    return jt, tt, D, C, P


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _ref(tt, D, C, P, signs, img):
    out = tt.clone()
    apply_ops.apply_tsdf_ops_ref(out, _t(D), _t(C), _t(P), _t(signs, torch.float32),
                                 _t(img, torch.int32), TINTR, TPARAMS)
    return out


def _assert_payload(jt, tt):
    np.testing.assert_array_equal(np.asarray(jt.weight), tt.weight.numpy())
    np.testing.assert_allclose(tt.sdf.numpy(), np.asarray(jt.sdf), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt.color.numpy(), np.asarray(jt.color), rtol=0, atol=ATOL)


@pytest.mark.parametrize("signs,img", [
    ([1.0, 1.0, -1.0], [0, 1, 0]),
    ([1.0, 1.0, 1.0], [0, 1, 2]),
    ([1.0, -1.0, 1.0], [2, 2, 1]),
])
def test_ref_matches_xla_twin(setup, signs, img):
    jt, tt, D, C, P = setup
    jr = japply.apply_tsdf_ops_xla(jt, jnp.asarray(D), jnp.asarray(C), jnp.asarray(P),
                                   jnp.asarray(signs, jnp.float32),
                                   jnp.asarray(img, jnp.int32), INTR, PARAMS)
    tr = _ref(tt, D, C, P, signs, img)
    _assert_payload(jr, tr)
    assert float(tr.weight.max()) > 0


def test_rows_core_matches_xla(setup):
    jt, tt, D, C, P = setup
    rows = np.nonzero(tt.slot_keys[:-1].numpy() != ttab.EMPTY_KEY)[0][::3]
    args = (P, np.asarray([1.0, 1.0, -1.0], np.float32), np.asarray([0, 1, 0], np.int32))
    js, jw, jc = japply.apply_tsdf_ops_rows(
        jnp.asarray(tt.slot_keys.numpy()[rows]), jnp.asarray(jt.sdf)[rows],
        jnp.asarray(jt.weight)[rows], jnp.asarray(jt.color)[rows], jnp.asarray(D),
        jnp.asarray(C), *map(jnp.asarray, args), INTR, PARAMS)
    r = torch.from_numpy(rows)
    ts, tw, tc = apply_ops.apply_tsdf_ops_rows(
        tt.slot_keys[r], tt.sdf[r], tt.weight[r], tt.color[r], _t(D), _t(C),
        *map(_t, args), TINTR, TPARAMS)
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)


def test_sign_zero_is_bitwise_noop(setup):
    _, tt, D, C, P = setup
    t1 = _ref(tt, D, C, P, [1.0, 0.0, 0.0], [0, 1, 2])
    t2 = _ref(t1, D, C, P, [0.0, -0.0, 0.0], [0, 1, 2])
    for name in ("sdf", "weight", "color"):
        assert torch.equal(getattr(t1, name), getattr(t2, name)), name


def test_integrate_then_deintegrate_restores_weights(setup):
    _, tt, D, C, P = setup
    t_a = _ref(tt, D[:1], C[:1], P[:1], [1.0], [0])
    t_b = _ref(tt, D[:2], C[:2], np.stack([P[0], P[1], P[1]]), [1.0, 1.0, -1.0], [0, 1, 1])
    assert torch.equal(t_a.weight, t_b.weight)
    np.testing.assert_allclose(t_b.sdf.numpy(), t_a.sdf.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_b.color.numpy(), t_a.color.numpy(), rtol=0, atol=1e-5)
    t_c = _ref(t_a, D[:1], C[:1], P[:1], [-1.0], [0])
    assert float(t_c.weight.abs().max()) == 0.0


def _cull_masks(tt, P, signs, D, op_dmax=None):
    w2c = pose_inverse(_t(P))
    return apply_ops.active_block_rows(tt, w2c, _t(signs, torch.float32), TINTR, TPARAMS,
                                       D.shape[1], D.shape[2], op_dmax=op_dmax)


def _cull(tt, P, signs, D):
    return _cull_masks(tt, P, signs, D)[0]


@pytest.mark.parametrize("pose_shift", [0.0, 0.6])
def test_cull_excludes_only_untouched_rows(setup, pose_shift):
    _, tt, D, C, P = setup
    P = P.copy()
    P[:, 0, 3] += pose_shift  # move the cameras so part of the map leaves the view
    signs = [1.0, -1.0, 1.0]
    rows = _cull(tt, P, signs, D).long()
    excluded = torch.ones(tt.num_blocks + 1, dtype=torch.bool)
    excluded[rows] = False
    full = _ref(tt, D, C, P, signs, [0, 1, 2])
    for name in ("sdf", "weight", "color"):
        assert torch.equal(getattr(full, name)[excluded], getattr(tt, name)[excluded]), name
    live = int((tt.slot_keys[:-1] != ttab.EMPTY_KEY).sum())
    assert 0 < rows.shape[0] <= live
    if pose_shift:
        assert rows.shape[0] < live  # the cull does exclude blocks


def test_culled_launch_interface_equals_full_sweep(setup):
    """The kernels' computation at their launch interfaces (packed samples,
    culled rows with op masks, host signs and image indices), run in plain
    PyTorch, is bitwise the full sweep."""
    _, tt, D, C, P = setup
    signs, img = [1.0, -1.0, 0.0], [0, 1, 2]
    full = _ref(tt, D, C, P, signs, img)
    part = tt.clone()
    apply_ops._apply_culled(part, _t(D), _t(C), _t(P), _t(signs, torch.float32),
                            _t(img, torch.int32), TINTR, TPARAMS, apply_ops.PLAIN_STAGES)
    for name in ("sdf", "weight", "color"):
        assert torch.equal(getattr(full, name), getattr(part, name)), name


def test_cpu_wrapper_is_the_plain_sweep(setup):
    _, tt, D, C, P = setup
    a = tt.clone()
    apply_ops.apply_tsdf_ops(a, _t(D), _t(C), _t(P), _t([1.0, 1.0, -1.0], torch.float32),
                             _t([0, 1, 0], torch.int32), TINTR, TPARAMS)
    b = _ref(tt, D, C, P, [1.0, 1.0, -1.0], [0, 1, 0])
    assert torch.equal(a.weight, b.weight) and torch.equal(a.sdf, b.sdf)


def _dirty(n=3, seed=0):
    """Images with invalid, huge and negative values among ordinary ones."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.3, 5.0, (n, 60, 80)).astype(np.float32)
    c = rng.uniform(0.0, 1.0, (n, 60, 80, 3)).astype(np.float32)
    d[0, :5] = np.nan
    d[1, 7, :9] = np.inf
    d[1, 8, :9] = -np.inf
    d[2, 3, 3] = 2e30
    d[2, 4, 4] = -1.5
    c[0, 0, 0] = np.nan
    c[1, 1, 1, 2] = 1e31
    return d, c


@pytest.mark.parametrize("images", ["sequence", "dirty", "no_depth"])
def test_pack_images_is_quantize_images(setup, images):
    """The packed samples are the quantised images bit for bit, and the
    per-image maxima their ``amax`` (0 where no depth is positive)."""
    _, _, D, C, _ = setup
    if images == "dirty":
        D, C = _dirty()
    elif images == "no_depth":
        D, C = np.full_like(D, np.nan), C
    d_q, c_q = apply_ops.quantize_images(_t(D), _t(C))
    packed, dmax = apply_ops.pack_images(_t(D), _t(C))
    assert packed.shape == (D.shape[0], 60, 80, 4) and packed.is_contiguous()
    assert torch.equal(packed[..., 0].view(torch.int32), d_q.view(torch.int32))
    assert torch.equal(packed[..., 1:].contiguous().view(torch.int32), c_q.view(torch.int32))
    amax = torch.amax(d_q.reshape(D.shape[0], -1), dim=1)
    assert torch.equal(dmax, torch.clamp(amax, min=0.0))
    if images != "no_depth":
        assert torch.equal(dmax, amax) and float(dmax.min()) > 0
    else:
        assert float(dmax.max()) == 0.0


@pytest.mark.parametrize("pose_shift", [0.0, 0.6])
@pytest.mark.parametrize("op", [0, 1, 2])
def test_op_mask_is_conservative(setup, pose_shift, op):
    """For each op alone, every row the full plain sweep changes is listed
    with that op's bit set (far bound from the op image's largest depth,
    as the engine's path has it)."""
    _, tt, D, C, P = setup
    P = P.copy()
    P[:, 0, 3] += pose_shift
    signs = [1.0, -1.0, 1.0]
    base = _ref(tt, D, C, P, [1.0, 1.0, 1.0], [0, 1, 2])  # so -1 has weight to remove
    _, dmax = apply_ops.pack_images(_t(D), _t(C))
    rows, masks = _cull_masks(base, P, signs, D, op_dmax=dmax)
    assert rows.dtype == torch.int32 and masks.dtype == torch.int64
    assert torch.equal(rows, torch.sort(rows).values) and bool((masks != 0).all())
    has_bit = torch.zeros(base.num_blocks + 1, dtype=torch.bool)
    has_bit[rows.long()] = apply_ops.mask_bits(masks, 3)[:, op]
    alone = [s if o == op else 0.0 for o, s in enumerate(signs)]
    after = _ref(base, D, C, P, alone, [0, 1, 2])
    changed = torch.zeros(base.num_blocks + 1, dtype=torch.bool)
    for name in ("sdf", "weight", "color"):
        changed |= (getattr(after, name) != getattr(base, name)).any(dim=1)
    assert int(changed.sum()) > 0
    assert not bool((changed & ~has_bit).any())


def test_op_mask_skips_sign_zero_ops(setup):
    _, tt, D, _, P = setup
    rows, masks = _cull_masks(tt, P, [1.0, 0.0, -0.0], D)
    assert rows.shape[0] > 0
    assert torch.equal(apply_ops.mask_bits(masks, 3)[:, 1:].any(dim=0), torch.tensor([False, False]))


def test_world_to_camera_rows_are_pose_inverse(setup):
    """The culled path's world-to-camera rows are ``pose_inverse``'s, bit
    for bit, so kernel and plain full sweep project alike."""
    P = _t(setup[4])
    rows = apply_ops.world_to_camera_rows(P)
    assert rows.shape == (3, 3, 4) and rows.is_contiguous()
    assert torch.equal(rows.view(torch.int32), pose_inverse(P)[:, :3].contiguous().view(torch.int32))


def _culled(tt, D, C, P, signs, img):
    out = tt.clone()
    apply_ops._apply_culled(out, _t(D), _t(C), _t(P), signs, img, TINTR, TPARAMS,
                            apply_ops.PLAIN_STAGES)
    return out


@pytest.mark.parametrize("pose_shift", [0.0, 0.6])
@pytest.mark.parametrize("signs,img", [
    ([1.0, 1.0, -1.0], [0, 1, 0]),
    ([1.0, -1.0, 1.0], [2, 2, 1]),
])
def test_masked_sweep_equals_full_sweep_and_xla(setup, pose_shift, signs, img):
    """Applying each op only to the rows whose mask holds its bit changes
    nothing: weight bitwise and sdf / colour within 1e-6 of the full plain
    sweep, and of the JAX twin at the file's tolerance."""
    jt, tt, D, C, P = setup
    P = P.copy()
    P[:, 0, 3] += pose_shift
    part = _culled(tt, D, C, P, signs, img)
    full = _ref(tt, D, C, P, signs, img)
    assert torch.equal(part.weight, full.weight)
    np.testing.assert_allclose(part.sdf.numpy(), full.sdf.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(part.color.numpy(), full.color.numpy(), rtol=0, atol=ATOL)
    jr = japply.apply_tsdf_ops_xla(jt, jnp.asarray(D), jnp.asarray(C), jnp.asarray(P),
                                   jnp.asarray(signs, jnp.float32),
                                   jnp.asarray(img, jnp.int32), INTR, PARAMS)
    _assert_payload(jr, part)
    assert float(part.weight.max()) > 0


def test_masks_do_exclude_ops(setup):
    """With the cameras moved apart the masks differ between rows, so the
    masked sweep does skip (row, op) pairs the unmasked one would run."""
    _, tt, D, _, P = setup
    P = P.copy()
    P[1, 0, 3] += 0.6
    P[2, 0, 3] -= 0.6
    _, masks = _cull_masks(tt, P, [1.0, 1.0, 1.0], D)
    ops_per_row = apply_ops.mask_bits(masks, 3).sum(dim=1)
    assert int(ops_per_row.min()) >= 1 and int(ops_per_row.min()) < int(ops_per_row.max())


@pytest.mark.parametrize("kind", ["list", "cpu_tensor", "numpy"])
def test_host_signs_and_image_indices(setup, kind):
    _, tt, D, C, P = setup
    signs, img = [1.0, 1.0, -1.0], [0, 1, 0]
    conv = {"list": lambda x, dt: list(x),
            "cpu_tensor": lambda x, dt: torch.tensor(x, dtype=dt),
            "numpy": lambda x, dt: np.asarray(x)}[kind]
    a = tt.clone()
    apply_ops.apply_tsdf_ops(a, _t(D), _t(C), _t(P), conv(signs, torch.float32),
                             conv(img, torch.int32), TINTR, TPARAMS)
    b = _ref(tt, D, C, P, signs, img)
    c = _culled(tt, D, C, P, conv(signs, torch.float32), conv(img, torch.int32))
    for name in ("sdf", "weight", "color"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert torch.equal(getattr(c, name), getattr(b, name)), name


@pytest.mark.parametrize("entry", ["wrapper", "culled", "ref"])
@pytest.mark.parametrize("img", [[0, 3, 1], [0, -1, 1]])
def test_image_index_out_of_range_raises(setup, entry, img):
    _, tt, D, C, P = setup
    fn = {"wrapper": apply_ops.apply_tsdf_ops,
          "culled": lambda *a: apply_ops._apply_culled(*a, apply_ops.PLAIN_STAGES),
          "ref": apply_ops.apply_tsdf_ops_ref}[entry]
    before = tt.clone()
    with pytest.raises(ValueError):
        fn(tt, _t(D), _t(C), _t(P), [1.0, 1.0, 1.0], img, TINTR, TPARAMS)
    assert torch.equal(tt.weight, before.weight)
