"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card. The
file imports no JAX, so it runs on a machine that has only PyTorch and the
CUDA toolkit, without the repository's JAX-side ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Two tests drive ``frame_step`` on the card: against the CPU run on three
frames (``valid`` equal, ``T_world`` within 2e-3), and twice on the card
(``valid`` equal, ``T_world`` within 1e-5). The last ones hold the card
against the CPU for one ``solve_bundle`` (poses within 1e-4: the same float32
sums in another order, and another LU), one ``_submap_step`` from the same
state (flags equal, poses within 2e-3) and a 13-frame ``process_frame`` +
``finish`` run (flags equal, trajectory within 5e-3, as the CPU test holds
the port to the JAX engine), and run the engine twice on the card: the same
flags, and the same trajectory bit for bit. The multi-device path runs on 2
``gloo`` ranks on the card: ``make_sharded_apply`` (the kernels over each
rank's rows) against the plain sweep, and the sharded solver against the
single-device PCG solve on the CPU. The boundary of
``scripts.profile_boundary`` at G = 32 runs on the card against the CPU,
exact and past both working-set caps.

The greedy Kabsch filter's kernel is held against its plain version on
the card: on real matches of the synthetic orbit at the per-frame shape (10
pairs of 128 raw matches) and at global ones (64 and 640 pairs), and on the
edge cases of ``tests/torch_kabsch_cases.py`` (R = 33, R = 1024 and 130 mixed
pairs among them); masks, counts and validity equal,
transforms within 1e-4 (the plain version's tiny products go through cuBLAS,
the kernel rounds each product and sum in order), two calls bit for bit equal
and none waiting for the device. A pair that the plain version itself
decides one way on the card and another on the CPU (float32 rounding decides
it) must get one of its two answers. Packed several to a CTA (650 pairs), each
pair's results are the bits it gets in a batch of 130.

The surface-area filter's kernel is held against its plain version on the
same real matches (with the greedy kernel's inlier masks) at 10, 64 and 640
pairs and on the edge cases of ``tests/torch_surface_area_cases.py``: areas
within 1e-5 or 1e-4 relative and keep flags equal where the reference is
well-posed, two calls bit for bit and none waiting. One eager
``_frame_step`` runs under ``set_sync_debug_mode("error")``, and 22 frames
with two boundaries through ``process_frame`` replaying the captured graphs
equal the same frames run eagerly bit for bit (poses, flags, the window
after every frame), with the same kernel launches.

Inputs are the apply test's setup (3 synthetic frames at 80x60, 4 cm
voxels) made by the port's own synthetic module. Limits: the image pass
bitwise; the cull a superset of the rows the plain full sweep changes; the
sweep and the whole op weight exact, sdf and colour within 1e-6 (the kernel
rounds each product and the division like the plain version does; 1e-6
leaves room for one rounding of a running average near 1).
"""

import numpy as np
import pytest
import torch

from bundlefusion_tpu_torch import kernels
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics
from bundlefusion_tpu_torch.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu_torch.tsdf import apply_ops
from bundlefusion_tpu_torch.tsdf import integrate as tint
from bundlefusion_tpu_torch.tsdf import table as ttab

pytestmark = pytest.mark.cuda

ATOL = 1e-6
TSDF_KERNELS = ("tsdf_prepare", "tsdf_cull", "tsdf_apply")  # the fused TSDF op's three
PARAMS = tint.TsdfParams(voxel_size=0.04, truncation=0.12, max_integration_distance=4.0)


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    intr_in = default_intrinsics(160, 120)
    intr = CameraIntrinsics(**intr_in.scaled(80, 60).__dict__)
    seq = make_sequence(3, intr=intr_in)
    D = torch.from_numpy(np.ascontiguousarray(seq["depth"][:, ::2, ::2]))
    C = torch.from_numpy(np.ascontiguousarray(seq["color"][:, ::2, ::2]))
    P = torch.from_numpy(seq["poses"].astype(np.float32))
    t = ttab.create_table(4096, 2048, "cpu")
    for i in range(3):
        tint.allocate_for_frame(t, D[i], intr, P[i], PARAMS)
    t = ttab.VoxelBlockTable(**{k: v.to(dev) for k, v in t.__dict__.items()})
    D, C, P = D.to(dev), C.to(dev), P.to(dev)
    # a fused base state, so de-integration has something to remove
    apply_ops.apply_tsdf_ops_ref(t, D, C, P, torch.ones(3, device=dev),
                                 torch.arange(3, dtype=torch.int32, device=dev), intr, PARAMS)
    return t, D, C, P, intr


def _batch(P, signs, img):
    dev = P.device
    return (P[torch.tensor(img, device=dev).long()], torch.tensor(signs, device=dev),
            torch.tensor(img, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("signs,img", [
    ([1.0], [2]),
    ([1.0, -1.0, 0.0], [0, 1, 2]),
    ([-1.0, 1.0] * 5 + [1.0], [0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2]),
])
def test_kernel_matches_plain(setup, signs, img):
    base, D, C, P, intr = setup
    poses, s, im = _batch(P, signs, img)
    poses = poses.clone()
    poses[1::2, 0, 3] += 0.02  # the re-integration pose differs from the old one
    k, r = base.clone(), base.clone()
    before = dict(kernels.launch_counts)
    after = {name: n + (name in TSDF_KERNELS) for name, n in before.items()}
    apply_ops.apply_tsdf_ops(k, D, C, poses, s, im, intr, PARAMS)
    assert kernels.launch_counts == after
    apply_ops.apply_tsdf_ops_ref(r, D, C, poses, s, im, intr, PARAMS)
    assert kernels.launch_counts == after
    torch.cuda.synchronize()
    assert torch.equal(k.weight, r.weight)
    assert float((k.sdf - r.sdf).abs().max()) <= ATOL
    assert float((k.color - r.color).abs().max()) <= ATOL
    assert not torch.equal(k.weight, base.weight)


def test_sign_zero_is_bitwise_noop_on_card(setup):
    base, D, C, P, intr = setup
    k = base.clone()
    apply_ops.apply_tsdf_ops(k, D, C, *_batch(P, [0.0, -0.0, 0.0], [0, 1, 2]), intr, PARAMS)
    torch.cuda.synchronize()
    for name in ("sdf", "weight", "color"):
        assert torch.equal(getattr(k, name), getattr(base, name)), name


def test_launcher_rejects_host_tensors(setup):
    base, D, C, P, intr = setup
    host = ttab.VoxelBlockTable(**{k: v.cpu() for k, v in base.__dict__.items()})
    dev = D.device
    rows = torch.zeros(1, dtype=torch.int32, device=dev)
    masks = torch.ones(1, dtype=torch.int64, device=dev)
    n_rows = torch.ones(1, dtype=torch.int32, device=dev)
    packed, dmax = kernels.tsdf_prepare_launch(D[:1], C[:1])
    w2c = torch.eye(4, device=dev)[None, :3].contiguous()
    with pytest.raises(ValueError):
        kernels.tsdf_apply_launch(host, rows, masks, n_rows, packed, w2c, [1.0], [0],
                                  intr, PARAMS)
    with pytest.raises(ValueError):
        kernels.tsdf_cull_launch(host, w2c, [1.0], [0], dmax, intr, PARAMS, 60, 80)
    with pytest.raises(ValueError):
        kernels.tsdf_prepare_launch(D[:1].cpu(), C[:1].cpu())
    with pytest.raises(ValueError):  # image index out of range
        kernels.tsdf_apply_launch(base.clone(), rows, masks, n_rows, packed, w2c, [1.0], [1],
                                  intr, PARAMS)


def test_prepare_matches_plain_bitwise(setup):
    _, D, C, _, _ = setup
    D, C = D.clone(), C.clone()
    D[0, :5] = float("nan")
    D[1, 7, :9] = float("inf")
    D[1, 8, :9] = float("-inf")
    D[2, 3, 3] = 2e30
    D[2, 4, 4] = -1.5
    C[0, 0, 0] = float("nan")
    C[1, 1, 1, 2] = 1e31
    before = kernels.launch_counts["tsdf_prepare"]
    packed, dmax = kernels.tsdf_prepare_launch(D, C)
    assert kernels.launch_counts["tsdf_prepare"] == before + 1
    ref_packed, ref_dmax = apply_ops.pack_images(D, C)
    torch.cuda.synchronize()
    assert torch.equal(packed.view(torch.int32), ref_packed.view(torch.int32))
    assert torch.equal(dmax, ref_dmax) and float(dmax.min()) > 0
    none = torch.full_like(D[:1], float("nan"))
    _, dmax0 = kernels.tsdf_prepare_launch(none, C[:1])
    assert float(dmax0[0]) == 0.0


@pytest.mark.parametrize("pose_shift", [0.0, 0.6])
def test_cull_lists_every_row_the_full_sweep_changes(setup, pose_shift):
    base, D, C, P, intr = setup
    P = P.clone()
    P[:, 0, 3] += pose_shift
    signs, img = [1.0, -1.0, 1.0], [0, 1, 2]
    w2c = apply_ops.world_to_camera_rows(P)
    packed, dmax = kernels.tsdf_prepare_launch(D, C)
    before = kernels.launch_counts["tsdf_cull"]
    rows, masks, n_rows = kernels.tsdf_cull_launch(base, w2c, signs, img, dmax, intr, PARAMS,
                                                   60, 80)
    assert kernels.launch_counts["tsdf_cull"] == before + 1
    n = int(n_rows)
    listed = rows[:n].long()
    assert n > 0 and torch.unique(listed).shape[0] == n
    live = base.slot_keys[:-1] != ttab.EMPTY_KEY
    assert bool(live[listed].all())
    if pose_shift:
        assert n < int(live.sum())  # the cull does exclude blocks
    # per op: every row that op alone changes is listed with its bit
    bits = torch.zeros((base.num_blocks + 1, 3), dtype=torch.bool, device=D.device)
    bits[listed] = apply_ops.mask_bits(masks[:n], 3)
    for op in range(3):
        alone = [s if o == op else 0.0 for o, s in enumerate(signs)]
        after = base.clone()
        apply_ops.apply_tsdf_ops_ref(after, D, C, P, alone, img, intr, PARAMS)
        changed = torch.zeros(base.num_blocks + 1, dtype=torch.bool, device=D.device)
        for name in ("sdf", "weight", "color"):
            changed |= (getattr(after, name) != getattr(base, name)).any(dim=1)
        assert int(changed.sum()) > 0
        assert not bool((changed & ~bits[:, op]).any()), op
    # and it agrees with the plain cull up to blocks on the edge of the test
    p_rows, p_masks = apply_ops.active_block_rows(base, w2c, signs, intr, PARAMS, 60, 80,
                                                  op_dmax=dmax[torch.tensor(img)])
    both = np.intersect1d(listed.cpu().numpy(), p_rows.cpu().numpy()).shape[0]
    assert both >= 0.99 * max(n, p_rows.shape[0])


@pytest.mark.parametrize("signs,img", [
    ([1.0], [2]),
    ([-1.0, 1.0] * 5 + [1.0], [0, 0, 1, 1, 2, 2, 0, 0, 1, 1, 2]),
])
def test_two_calls_give_bitwise_equal_tables(setup, signs, img):
    """The row list's order changes from run to run; the result must not.
    Also: host signs / image indices, and no wait for the device inside."""
    base, D, C, P, intr = setup
    poses = P[torch.tensor(img, device=P.device).long()].clone()
    poses[1::2, 0, 3] += 0.02
    apply_ops.apply_tsdf_ops(base.clone(), D, C, poses, signs, img, intr, PARAMS)  # build
    a, b = base.clone(), base.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        apply_ops.apply_tsdf_ops(a, D, C, poses, signs, img, intr, PARAMS)
        apply_ops.apply_tsdf_ops(b, D, C, poses, signs, img, intr, PARAMS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for name in ("sdf", "weight", "color"):
        assert torch.equal(getattr(a, name).view(torch.int32),
                           getattr(b, name).view(torch.int32)), name
    assert not torch.equal(a.weight, base.weight)


def test_image_index_out_of_range_raises_on_card(setup):
    base, D, C, P, intr = setup
    with pytest.raises(ValueError):
        apply_ops.apply_tsdf_ops(base.clone(), D, C, P, [1.0, 1.0, 1.0], [0, 3, 1], intr, PARAMS)


def _frame_step_run(device, n=3):
    """``n`` frames of the 160x120 synthetic orbit through ``_frame_step``
    at the small configuration: per frame (T_world, valid) on the host."""
    from bundlefusion_tpu_torch import AppConfig, BundlingConfig, SiftConfig
    from bundlefusion_tpu_torch.io.synthetic import make_sequence_wire
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    intr = default_intrinsics(160, 120)
    seq = make_sequence_wire(n, intr=intr)
    eng = BundleFusion(
        intr,
        AppConfig(integration_width=80, integration_height=60, sdf_voxel_size=0.03,
                  sdf_truncation=0.09, hash_num_sdf_blocks=8192, hash_key_capacity=16384,
                  visible_blocks_cap=8192),
        BundlingConfig(width_sift=160, height_sift=120, submap_size=8, downsampled_width=40,
                       downsampled_height=30, max_local_corr=2048, max_global_corr=8192,
                       min_num_matches_local=4, min_num_matches_global=4),
        sift_cfg=SiftConfig(num_octaves=3, target_keys=96, max_candidates_per_octave=256,
                            min_scale=1.0, dog_thresh=0.004),
        max_keyframes=4, device=device)
    out = []
    for f in range(n):
        T, v = eng._frame_step(seq["depth"][f], seq["color"][f], f, f)
        assert T.device.type == torch.device(device).type
        out.append(eng._read_pose(T, v))
    return out


def test_frame_step_on_card_matches_cpu(setup):
    card, cpu = _frame_step_run("cuda"), _frame_step_run("cpu")
    assert [v for _, v in card] == [v for _, v in cpu] == [True] * 3
    for (Tc, _), (Th, _) in zip(card, cpu):
        np.testing.assert_allclose(Tc, Th, rtol=0, atol=2e-3)
    assert np.linalg.norm(card[-1][0][:3, 3]) > 0.01


def test_frame_step_twice_on_card(setup):
    a, b = _frame_step_run("cuda"), _frame_step_run("cuda")
    assert [v for _, v in a] == [v for _, v in b]
    for (Ta, _), (Tb, _) in zip(a, b):
        np.testing.assert_allclose(Ta, Tb, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the solver, one boundary and the whole engine: card against CPU
# ---------------------------------------------------------------------------

ENGINE_FRAMES = 13


def _small_engine(device, **bund):
    from bundlefusion_tpu_torch import AppConfig, BundlingConfig, SiftConfig
    from bundlefusion_tpu_torch.pipeline.online import BundleFusion

    cfg = dict(width_sift=160, height_sift=120, submap_size=4, downsampled_width=40,
               downsampled_height=30, max_local_corr=2048, max_global_corr=8192,
               min_num_matches_local=4, min_num_matches_global=4)
    cfg.update(bund)
    return BundleFusion(
        default_intrinsics(160, 120),
        AppConfig(integration_width=80, integration_height=60, sdf_voxel_size=0.03,
                  sdf_truncation=0.09, hash_num_sdf_blocks=8192, hash_key_capacity=16384,
                  visible_blocks_cap=8192, alloc_max_new_blocks_per_frame=8192),
        BundlingConfig(**cfg),
        sift_cfg=SiftConfig(num_octaves=3, target_keys=96, max_candidates_per_octave=256,
                            min_scale=1.0, dog_thresh=0.004),
        max_keyframes=8, device=device)


def _engine_run(device, n=ENGINE_FRAMES):
    from bundlefusion_tpu_torch.io.synthetic import make_sequence_wire

    seq = make_sequence_wire(n, intr=default_intrinsics(160, 120))
    eng = _small_engine(device)
    eng.warmup()
    for f in range(n):
        out = eng.process_frame(eng.upload_frame(seq["depth"][f], seq["color"][f]))
        assert out["pose"].device.type == torch.device(device).type
    eng.finish(extra_solves=1)
    return eng


def _moved(obj, device):
    """A copy of a (nested) dataclass of tensors on ``device``."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kw[f.name] = v.to(device).clone() if isinstance(v, torch.Tensor) else _moved(v, device)
    return type(obj)(**kw)


@pytest.fixture(scope="module")
def window_state(setup):
    """A CPU engine stopped just before its second boundary (frame 8 stepped,
    boundary not yet run), and that frame's pose."""
    from bundlefusion_tpu_torch.io.synthetic import make_sequence_wire

    seq = make_sequence_wire(9, intr=default_intrinsics(160, 120))
    eng = _small_engine("cpu")
    for f in range(8):
        eng.process_frame(seq["depth"][f], seq["color"][f])
    T, _ = eng._frame_step(seq["depth"][8], seq["color"][8], 4, 8)
    assert eng.num_keyframes == 1 and bool(eng.local.valid.all())
    return eng, T


def test_solve_bundle_on_card_matches_cpu(window_state):
    from bundlefusion_tpu_torch.geometry.lie import matrix_to_pose
    from bundlefusion_tpu_torch.solver.gn_pcg import solve_bundle

    eng, _ = window_state
    out = {}
    for device in ("cpu", "cuda"):
        loc = _moved(eng.local, device)
        poses, stats = solve_bundle(matrix_to_pose(loc.rel), loc.valid, loc.corrs, loc.cache,
                                    eng.intr_cache, eng.local_solver, eng.dense_term_params)
        assert poses.device.type == device
        out[device] = (poses.cpu().numpy(), float(stats.final_cost), float(stats.initial_cost))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-2, atol=1e-7)
    assert out["cuda"][1] < out["cuda"][2]
    assert np.abs(out["cuda"][0][1:]).max() > 1e-3     # the window moved


def test_submap_step_on_card_matches_cpu(window_state):
    src, T = window_state
    packs = {}
    for device in ("cpu", "cuda"):
        eng = _small_engine(device)
        eng.local, eng.glob = _moved(src.local, device), _moved(src.glob, device)
        eng.kf_valid_dev = src.kf_valid_dev.to(device).clone()
        eng.submap_base = src.submap_base.to(device).clone()
        packs[device] = eng._submap_step(1, T.to(device)).cpu().numpy()
        assert eng.boundary_stats[-1]["prune_rounds"] == 0
    a, b = packs["cuda"], packs["cpu"]
    flags = slice(eng._off_lv, eng._off_comp)
    np.testing.assert_array_equal(a[flags], b[flags])
    np.testing.assert_array_equal(a[eng._off_ok:], b[eng._off_ok:])
    assert a[eng._off_flags] == 1.0 and a[eng._off_flags + 1] == 1.0
    ok = np.repeat(b[eng._off_ok:] > 0.5, 16)
    assert ok.sum() == 16 * 8
    np.testing.assert_allclose(a[eng._off_comp:eng._off_ok][ok], b[eng._off_comp:eng._off_ok][ok],
                               rtol=0, atol=2e-3)


@pytest.fixture(scope="module")
def card_engine_runs(setup):
    return _engine_run("cuda"), _engine_run("cuda")


def test_engine_on_card_matches_cpu(card_engine_runs):
    from bundlefusion_tpu_torch.tsdf.table import check_invariants

    card, cpu = card_engine_runs[0], _engine_run("cpu")
    assert card.frame_valid == cpu.frame_valid == [True] * ENGINE_FRAMES
    np.testing.assert_array_equal(card.keyframe_valid, cpu.keyframe_valid)
    assert card.num_keyframes == cpu.num_keyframes == 3
    assert (card.lost_count, card.retry_list) == (cpu.lost_count, cpu.retry_list) == (0, [])
    assert card.reint_frames > 0 and kernels.launch_counts["tsdf_apply"] > 0
    for Tc, Th in zip(card.trajectory(), cpu.trajectory()):
        assert np.isfinite(Tc).all()
        np.testing.assert_allclose(Tc, Th, rtol=0, atol=5e-3)
    assert all(v == 0 for v in check_invariants(card.table).values())
    assert len(card.extract_mesh()[0]) > 10_000


def test_engine_twice_on_card(card_engine_runs):
    a, b = card_engine_runs
    assert a.frame_valid == b.frame_valid
    np.testing.assert_array_equal(a.keyframe_valid, b.keyframe_valid)
    assert (a.reint_frames, a.reint_ops_total) == (b.reint_frames, b.reint_ops_total)
    np.testing.assert_array_equal(a.trajectory(), b.trajectory())
    np.testing.assert_array_equal(np.stack(a.sift_world), np.stack(b.sift_world))


def _host_copy(t):
    return ttab.VoxelBlockTable(**{k: v.cpu().clone() for k, v in t.__dict__.items()})


def test_stream_out_in_on_card_matches_cpu(setup):
    """Host paging of a CUDA table equals the same on a CPU table, bit for
    bit: the same paged keys and payloads, the same table after the blocks
    come back."""
    from bundlefusion_tpu_torch.tsdf import streaming

    base, _, _, P, _ = setup
    card, host = base.clone(), _host_copy(base)
    cam = P[0, :3, 3].cpu().numpy()
    stores = [streaming.HostBlockStore(), streaming.HostBlockStore()]
    for t, store in zip((card, host), stores):
        streaming.stream_out(t, store, cam, 1.0, PARAMS.voxel_size)
    assert list(stores[0].blocks) == list(stores[1].blocks) and len(stores[0]) > 0
    for k, rows in stores[1].blocks.items():
        for a, b in zip(stores[0].blocks[k], rows):
            np.testing.assert_array_equal(a, b)
    for name, v in host.__dict__.items():
        assert torch.equal(getattr(card, name).cpu(), v), name
    some = list(stores[0].blocks)[:5]
    for t, store in zip((card, host), stores):
        streaming.stream_in_keys(t, store, some)
        streaming.stream_in(t, store, cam, 10.0, PARAMS.voxel_size)
    assert len(stores[0]) == len(stores[1]) == 0
    for name, v in host.__dict__.items():
        assert torch.equal(getattr(card, name).cpu(), v), name
    assert all(v == 0 for v in ttab.check_invariants(card).values())


@pytest.mark.parametrize("shift", [0.0, 0.05])
def test_raycast_on_card_matches_cpu(setup, shift):
    """The raycast on the card within 1e-5 of the CPU's (hit masks equal but
    for ulp-edge pixels, at most 0.1 %)."""
    from bundlefusion_tpu_torch.tsdf.raycast import raycast

    base, _, _, P, intr = setup
    pose = P[1].clone()
    pose[0, 3] += shift
    rc = raycast(base, intr, pose, PARAMS)
    rh = raycast(_host_copy(base), intr, pose.cpu(), PARAMS)
    dc, dh = rc["depth"].cpu().numpy(), rh["depth"].numpy()
    hc, hh = np.isfinite(dc), np.isfinite(dh)
    assert hh.sum() > 0.3 * dh.size and (hc != hh).mean() <= 1e-3
    both = hc & hh
    np.testing.assert_allclose(dc[both], dh[both], rtol=0, atol=1e-5)
    for key in ("color", "points", "normals"):
        a, b = rc[key].cpu().numpy()[both], rh[key].numpy()[both]
        fa, fb = np.isfinite(a).all(-1), np.isfinite(b).all(-1)
        # a normal is nan where a neighbour missed (silhouettes) on both
        assert (fa != fb).mean() <= 1e-2 and fa.mean() > 0.5, key
        ok = fa & fb
        np.testing.assert_allclose(a[ok], b[ok], rtol=0, atol=1e-5, err_msg=key)


# ---- the multi-device path: 2 gloo ranks on one card. The ranks' code is
# ``tests/torch_mesh_workers.py``, imported by its own name: pytest puts
# ``tests/`` on the path of this file (and of the ranks it starts) ----

def _rdzv(tmp_path):
    return "file://" + str(tmp_path / "rdzv_store")


def test_sharded_apply_on_card_matches_plain(setup, tmp_path):
    """``make_sharded_apply`` on 2 ``gloo`` ranks on the card: each rank
    runs the three CUDA kernels over its half of the rows; the gathered
    payload equals the plain full sweep (weights exact, sdf / colour within
    1e-6) and a de-integrate returns every weight to 0."""
    from bundlefusion_tpu_torch.parallel.mesh import run_ranks
    from torch_mesh_workers import map_scenarios

    base, D, C, P, intr = setup
    kernels.build_all()  # before the ranks start: no two builds race
    t = ttab.create_table(4096, 2048, "cpu")
    Dh, Ch, Ph = D.cpu(), C.cpu(), P.cpu()
    for i in range(2):
        tint.allocate_for_frame(t, Dh[i], intr, Ph[i], PARAMS)
    arrays = {k: v.numpy() for k, v in t.__dict__.items()}
    ranks = run_ranks(map_scenarios, 2, arrays, Dh[:2].numpy(), Ch[:2].numpy(),
                      Ph[:2].numpy(), dict(intr.__dict__), dict(PARAMS.__dict__),
                      device="cuda:0", init_method=_rdzv(tmp_path))
    ref = t.clone()
    apply_ops.apply_tsdf_ops_ref(ref, Dh[:2], Ch[:2], Ph[:2], [1.0, 1.0], [0, 1], intr, PARAMS)
    for r in ranks:
        assert all(r["launches"][k] >= 3 for k in TSDF_KERNELS), r["launches"]
        assert r["launches"]["kabsch_filter"] == 0
        out = r["integrated"]
        np.testing.assert_array_equal(out["weight"], ref.weight.numpy())
        np.testing.assert_allclose(out["sdf"], ref.sdf.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(out["color"], ref.color.numpy(), rtol=0, atol=ATOL)
        assert r["once"]["weight"].sum() > 0
        np.testing.assert_array_equal(r["round_trip"]["weight"], t.weight.numpy())


def test_two_rank_solve_on_card(setup, tmp_path):
    """``solve_sparse_sharded`` and the chunk solver on 2 ``gloo`` ranks on
    the card against the single-device PCG solve on the CPU (poses within
    2e-3, cost under 1e-5, no pair dropped); the collectives cross through
    host copies, which the mesh counts."""
    from bundlefusion_tpu_torch.io.synthetic import ring_pose_graph
    from bundlefusion_tpu_torch.parallel.mesh import run_ranks
    from bundlefusion_tpu_torch.solver import gn_pcg
    from bundlefusion_tpu_torch.solver.residuals import corr_store_from_numpy
    from torch_mesh_workers import solver_scenarios

    gt, arrays = ring_pose_graph(24, 16, 3)
    rng = np.random.default_rng(0)
    init = gt + rng.normal(size=gt.shape).astype(np.float32) * 0.01
    init[0] = gt[0]
    params = dict(num_gn=3, num_pcg=60, linear="pcg")
    ranks = run_ranks(solver_scenarios, 2, init, arrays, params, device="cuda:0",
                      init_method=_rdzv(tmp_path))
    ref, _ = gn_pcg.solve_sparse(torch.from_numpy(init), torch.ones(len(init), dtype=torch.bool),
                                 corr_store_from_numpy(arrays, "cpu"),
                                 gn_pcg.SolverParams(**params))
    for r in ranks:
        assert r["cost"] < 1e-5 and r["dropped"] == 0
        np.testing.assert_allclose(r["poses"], ref.numpy(), atol=2e-3)
        np.testing.assert_array_equal(r["chunk_poses"], r["poses"])
        assert r["stats"]["host_staged_bytes"] > 0
    np.testing.assert_array_equal(ranks[0]["poses"], ranks[1]["poses"])


@pytest.mark.parametrize("caps", [(1 << 18, 1 << 22), (100, 512)], ids=["exact", "overflow"])
def test_boundary_calls_on_card_match_cpu(setup, caps):
    """``scripts.profile_boundary``'s boundary (presort, solve, largest
    residual, a prune round) at G = 32 on the card against the CPU, exact and
    past both working-set caps: the same ``dropped`` and working set, poses
    within 1e-4."""
    from bundlefusion_tpu_torch.scripts import profile_boundary

    problem = profile_boundary.build_problem(32, 8, np.random.default_rng(0))
    params = profile_boundary.solver_params(*caps)
    card = profile_boundary.boundary_calls(problem, params, torch.device("cuda"))
    host = profile_boundary.boundary_calls(problem, params, torch.device("cpu"))
    assert card["dropped"] == host["dropped"]
    assert (card["dropped"] > 0) == (caps[0] == 100)
    for k in ("working_img_i", "working_img_j", "working_valid"):
        np.testing.assert_array_equal(card[k], host[k])
    for k in ("poses", "poses_after_prune"):
        np.testing.assert_allclose(card[k], host[k], rtol=0, atol=1e-4)
    assert all(v is not None and v > 0 for v in card["times"].values())


# ---------------------------------------------------------------------------
# the greedy Kabsch filter: the kernel against its plain version
# ---------------------------------------------------------------------------

KABSCH_ARGS = (25, 4, 4e-4)  # max_filtered, min_num_matches, max_res2
KABSCH_T_ATOL = 1e-4


def _pairs_equal(a, b):
    """Per pair: validity, count and mask equal."""
    return ((a["valid_pair"] == b["valid_pair"]) & (a["count"] == b["count"])
            & (a["inlier_mask"] == b["inlier_mask"]).all(-1))


def _filter_outputs_equal(got, want, args):
    """The kernel's masks, counts and validity equal the plain version's on
    the card, and its transforms are within KABSCH_T_ATOL, on every pair the
    plain version decides alike on the card and on the CPU. A pair where
    those two differ is one that float32 rounding decides (a 3-point fit's
    condition number: the eigenvalues of H^T H that it divides lie below
    the closed-form solve's rounding); there the kernel must give one of
    the plain version's two answers."""
    from bundlefusion_tpu_torch.ops import filters

    cpu = {k: v.to(got["count"].device) if isinstance(v, torch.Tensor) else v
           for k, v in filters.kabsch_filter_ref(*(a.cpu() for a in args),
                                                 *KABSCH_ARGS).items()}
    split = ~_pairs_equal(want, cpu)
    as_card, as_cpu = _pairs_equal(got, want), _pairs_equal(got, cpu)
    assert bool((as_card | (split & as_cpu)).all()), (
        f"pairs {(~as_card).nonzero().flatten().tolist()} differ from the plain version "
        f"(card / CPU split: {split.nonzero().flatten().tolist()})")
    for same, ref in ((as_card, want), (~as_card, cpu)):
        err = (got["transform"] - ref["transform"]).abs().amax((-1, -2))[same]
        assert not bool((err > KABSCH_T_ATOL).any()), float(err.max())
    return int((~as_card).sum())


@pytest.fixture(scope="module")
def real_matches(setup):
    """The greedy filter's inputs as ``_frame_step`` hands them over on the
    card, over 11 frames of the 160x120 orbit in one window of 11 (frame f
    is matched against the f before it): the last frame's call (10 pairs)
    and all 55 pairs pooled."""
    from bundlefusion_tpu_torch.io.synthetic import make_sequence_wire
    from bundlefusion_tpu_torch.ops import filters
    from bundlefusion_tpu_torch.pipeline import frontend

    seq = make_sequence_wire(11, intr=default_intrinsics(160, 120))
    eng = _small_engine("cuda", submap_size=11)
    calls = []

    def capture(*args):
        calls.append([a.clone() for a in args[:5]])
        return filters.kabsch_filter(*args)

    frontend.kabsch_filter = capture
    try:
        for f in range(11):
            eng._frame_step(seq["depth"][f], seq["color"][f], f, f)
    finally:
        frontend.kabsch_filter = filters.kabsch_filter
    assert [c[4].shape for c in calls] == [(f, 128) for f in range(1, 11)]
    return calls[-1], [torch.cat([c[i] for c in calls]) for i in range(5)]


@pytest.mark.parametrize("pairs", [10, 64, 640], ids=["per_frame", "global", "global_640"])
def test_kabsch_kernel_matches_plain_on_real_matches(real_matches, pairs):
    from bundlefusion_tpu_torch.ops import filters

    last, pool = real_matches
    idx = torch.arange(pairs, device=pool[0].device) % pool[0].shape[0]
    args = last if pairs == 10 else [a[idx].contiguous() for a in pool]
    before = kernels.launch_counts["kabsch_filter"]
    got = filters.kabsch_filter(*args, *KABSCH_ARGS)
    assert kernels.launch_counts["kabsch_filter"] == before + 1 and got["host_reads"] == 0
    want = filters.kabsch_filter_ref(*args, *KABSCH_ARGS)
    assert kernels.launch_counts["kabsch_filter"] == before + 1 and want["host_reads"] > 0
    torch.cuda.synchronize()
    _filter_outputs_equal(got, want, args)
    assert int(want["valid_pair"].sum()) >= pairs // 2


@pytest.mark.parametrize("case", ["fewer_than_3", "all_invalid", "revert_at_3",
                                  "tie_for_worst", "fills_max_filtered", "no_pairs",
                                  "r33", "r1024", "mixed_130"])
def test_kabsch_kernel_matches_plain_on_edge_cases(setup, case):
    from bundlefusion_tpu_torch.ops import filters
    from torch_kabsch_cases import CASES   # tests/ is on the path of every test file

    arrays, check = CASES[case]()
    args = [torch.from_numpy(np.array(a)).cuda() for a in arrays]
    before = kernels.launch_counts["kabsch_filter"]
    got = filters.kabsch_filter(*args, *KABSCH_ARGS)
    assert kernels.launch_counts["kabsch_filter"] == before + (args[4].shape[0] > 0)
    want = filters.kabsch_filter_ref(*args, *KABSCH_ARGS)
    torch.cuda.synchronize()
    assert _filter_outputs_equal(got, want, args) == 0
    check({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in got.items()})


def test_kabsch_kernel_twice_bitwise_without_a_wait(real_matches):
    from bundlefusion_tpu_torch.ops import filters

    _, pool = real_matches
    filters.kabsch_filter(*pool, *KABSCH_ARGS)   # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = filters.kabsch_filter(*pool, *KABSCH_ARGS)
        b = filters.kabsch_filter(*pool, *KABSCH_ARGS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for k in ("valid_pair", "inlier_mask", "count"):
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(a["transform"].view(torch.int32), b["transform"].view(torch.int32))


def test_kabsch_kernel_pairs_do_not_depend_on_their_neighbours(setup):
    """The 130 mixed pairs tiled 5 times (650 pairs: more than the card has
    SMs, so several share a CTA, the last CTA part-filled): every tile's
    results are the bits of the 130-pair call."""
    from bundlefusion_tpu_torch.ops import filters
    from torch_kabsch_cases import CASES   # tests/ is on the path of every test file

    args = [torch.from_numpy(np.array(a)).cuda() for a in CASES["mixed_130"]()[0]]
    one = filters.kabsch_filter(*args, *KABSCH_ARGS)
    tiled = filters.kabsch_filter(*(a.repeat(5, *[1] * (a.dim() - 1)) for a in args),
                                  *KABSCH_ARGS)
    torch.cuda.synchronize()
    for k in ("valid_pair", "inlier_mask", "count", "transform"):
        want = one[k].repeat(5, *[1] * (one[k].dim() - 1))
        if k == "transform":
            assert torch.equal(tiled[k].view(torch.int32), want.view(torch.int32)), k
        else:
            assert torch.equal(tiled[k], want), k


# ---------------------------------------------------------------------------
# the surface-area filter's kernel, and _frame_step as captured graphs
# ---------------------------------------------------------------------------

SA_THRESH = 0.032


def _area_outputs(out):
    return tuple(x.cpu().numpy() for x in out)


def _surface_area_inputs(args):
    """The surface-area filter's inputs as ``match_and_filter`` hands them
    over: the raw matches' points and the greedy filter's inlier mask."""
    from bundlefusion_tpu_torch.ops import filters

    kf = filters.kabsch_filter(*args, *KABSCH_ARGS)
    return args[0], args[1], kf["inlier_mask"]


@pytest.mark.parametrize("pairs", [10, 64, 640], ids=["per_frame", "global", "global_640"])
def test_surface_area_kernel_matches_plain_on_real_matches(real_matches, pairs):
    from bundlefusion_tpu_torch.ops import filters
    from torch_surface_area_cases import compare   # tests/ is on the path of every test file

    last, pool = real_matches
    idx = torch.arange(pairs, device=pool[0].device) % pool[0].shape[0]
    args = _surface_area_inputs(last if pairs == 10 else [a[idx].contiguous() for a in pool])
    before = kernels.launch_counts["surface_area"]
    got = filters.surface_area_filter(*args, SA_THRESH)
    assert kernels.launch_counts["surface_area"] == before + 1
    want = filters.surface_area_filter_ref(*args, SA_THRESH)
    assert kernels.launch_counts["surface_area"] == before + 1
    torch.cuda.synchronize()
    arrays = tuple(a.cpu().numpy() for a in args)
    compare(_area_outputs(got), _area_outputs(want), arrays)
    assert int(got[0].sum()) >= pairs // 2


@pytest.mark.parametrize("case", ["random", "all_zero_mask", "one_to_three_inliers",
                                  "collinear_and_coplanar", "duplicates", "nan_inf",
                                  "near_threshold", "equal_eigenvalues"])
def test_surface_area_kernel_matches_plain_on_edge_cases(setup, case):
    from bundlefusion_tpu_torch.ops import filters
    from torch_surface_area_cases import CASES, compare

    arrays, check = CASES[case]()
    args = [torch.from_numpy(np.array(a)).cuda() for a in arrays]
    got = _area_outputs(filters.surface_area_filter(*args, SA_THRESH))
    want = _area_outputs(filters.surface_area_filter_ref(*args, SA_THRESH))
    check(got)
    compare(got, want, arrays)


def test_surface_area_kernel_twice_bitwise_without_a_wait(real_matches):
    from bundlefusion_tpu_torch.ops import filters

    _, pool = real_matches
    args = _surface_area_inputs(pool)
    filters.surface_area_filter(*args, SA_THRESH)   # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = filters.surface_area_filter(*args, SA_THRESH)
        b = filters.surface_area_filter(*args, SA_THRESH)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


GRAPH_FRAMES = 22   # windows of 10: boundaries at frames 10 and 20


def test_frame_step_waits_for_nothing(setup):
    """One eager ``_frame_step`` (frame 3 of the 12-frame orbit, matched
    against the 3 before it) under ``set_sync_debug_mode("error")``: no
    operator of the step makes the host wait for the card."""
    from bundlefusion_tpu_torch.io.synthetic import make_sequence_wire

    seq = make_sequence_wire(12, intr=default_intrinsics(160, 120))
    eng = _small_engine("cuda", submap_size=10)
    for f in range(3):
        eng._frame_step(seq["depth"][f], seq["color"][f], f, f)
    depth, color = eng.upload_frame(seq["depth"][3], seq["color"][3])
    slot = torch.full((1,), 3, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T, valid = eng._frame_step(depth, color, 3, slot)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(valid) and torch.isfinite(T).all()


def _window_snapshot(eng):
    """The window's state on the host: keys, cache, rel, corrs, validity."""
    import dataclasses

    snap = {"rel": eng.local.rel.cpu(), "valid": eng.local.valid.cpu()}
    for part in ("keys", "cache", "corrs"):
        obj = getattr(eng.local, part)
        snap.update({f"{part}.{f.name}": getattr(obj, f.name).cpu()
                     for f in dataclasses.fields(obj)})
    return snap


def _graph_or_eager_run(eager):
    from bundlefusion_tpu_torch.io.synthetic import make_sequence_wire

    seq = make_sequence_wire(GRAPH_FRAMES, intr=default_intrinsics(160, 120))
    eng = _small_engine("cuda", submap_size=10)
    eng._eager_frame_step = eager
    eng.warmup()
    assert len(eng._graphs) == (0 if eager else eng.S)
    for k in kernels.launch_counts:
        kernels.launch_counts[k] = 0
    poses, snaps = [], []
    for f in range(GRAPH_FRAMES):
        out = eng.process_frame(eng.upload_frame(seq["depth"][f], seq["color"][f]))
        poses.append((out["pose"].cpu(), out["valid"].cpu()))
        snaps.append(_window_snapshot(eng))
    launches = dict(kernels.launch_counts)
    eng.finish(extra_solves=1)
    return eng, poses, snaps, launches


@pytest.fixture(scope="module")
def graph_and_eager_runs(setup):
    return _graph_or_eager_run(eager=False), _graph_or_eager_run(eager=True)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else (
        t.view(torch.int16) if t.dtype == torch.bfloat16 else t)


def test_graph_replay_equals_eager_bitwise(graph_and_eager_runs):
    """22 frames and 2 boundaries, process_frame replaying the captured
    graphs and running the step eagerly: every frame's pose and validity,
    and the window after it, are the same bits."""
    (g_eng, g_poses, g_snaps, _), (e_eng, e_poses, e_snaps, _) = graph_and_eager_runs
    # two boundaries, and the trailing window that finish() solves
    assert g_eng.num_keyframes == e_eng.num_keyframes == 3
    assert g_eng.frame_valid == e_eng.frame_valid and all(g_eng.frame_valid)
    for f, ((gT, gv), (eT, ev)) in enumerate(zip(g_poses, e_poses)):
        assert torch.equal(_bits(gT), _bits(eT)) and torch.equal(gv, ev), f
    for f, (gs, es) in enumerate(zip(g_snaps, e_snaps)):
        for k in gs:
            assert torch.equal(_bits(gs[k]), _bits(es[k])), (f, k)
    np.testing.assert_array_equal(g_eng.trajectory(), e_eng.trajectory())


def test_launch_counts_under_replay_equal_eager(graph_and_eager_runs):
    (_, _, _, g_launches), (_, _, _, e_launches) = graph_and_eager_runs
    assert g_launches == e_launches
    # one filter launch of each kind per frame with a live pair, plus the
    # boundaries' global matches
    assert g_launches["kabsch_filter"] == g_launches["surface_area"] >= GRAPH_FRAMES - 1
