"""The state that ``_frame_step`` reads and writes keeps its storage, on the
CPU, and nothing in the step waits for the card.

On the card ``process_frame`` replays ``_frame_step`` as a CUDA graph
captured once per window slot, and a graph reads and writes the tensors it
was captured with, by address. So every tensor of the step's state (the
window: keypoint store, dense cache, correspondence store, relative poses,
validity; the frame archive; the window's anchor pose) must be the same
storage for the engine's life: through frames, boundaries and their
rollovers, ``warmup`` and a checkpoint's ``save`` -> ``load``. The engine is
driven at the small configuration over 25 frames, with windows of 10: two
boundaries, two rollovers.

And a capture fails on anything that waits for the card. The step is run
under a dispatch mode that sees every operator it calls, on the CPU: none
may be one that makes the host wait on a CUDA tensor (reading a value back,
``nonzero``, ``torch.linalg.eigh``, a copy of a host array to the card),
outside the plain versions of the two hand kernels, which the card runs as
``kernels/kabsch_filter.cu`` and ``kernels/surface_area.cu``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bundlefusion_tpu_torch.io.synthetic import make_sequence_wire
from bundlefusion_tpu_torch.pipeline import frontend
from bundlefusion_tpu_torch.pipeline.frames import create_frame_store, load_frames, put_frame
from bundlefusion_tpu_torch.pipeline.online import BundleFusion
from bundlefusion_tpu_torch.scripts import common
from bundlefusion_tpu_torch.solver.residuals import (
    append_corrs,
    compact_corrs,
    create_corr_store,
    invalidate_frame,
)

torch.set_num_threads(2)

N_FRAMES = 25
SUBMAP = 10
SAVE_AT = 15


def _engine():
    intr, app, bund, sift = common.small_config(submap_size=SUBMAP)
    return BundleFusion(intr, app, bund, sift_cfg=sift, max_keyframes=8, device="cpu")


def frame_state(eng) -> dict:
    """Every tensor ``_frame_step`` reads or writes that outlives it, by name."""
    out = {"submap_base": eng.submap_base, "rel": eng.local.rel, "valid": eng.local.valid,
           "store.depth_mm": eng.store.depth_mm, "store.color": eng.store.color}
    for part in ("keys", "cache", "corrs"):
        obj = getattr(eng.local, part)
        out.update({f"{part}.{f.name}": getattr(obj, f.name) for f in dataclasses.fields(obj)})
    return out


def _ptrs(eng) -> dict:
    return {k: t.data_ptr() for k, t in frame_state(eng).items()}


@pytest.fixture(scope="module")
def seq():
    return make_sequence_wire(N_FRAMES, intr=common.small_config()[0])


@pytest.fixture(scope="module")
def driven(seq, tmp_path_factory):
    """The engine built, warmed up and driven over the frames, saved at
    SAVE_AT: per frame the state's addresses, the ones right after the
    constructor, and the checkpoint's path."""
    eng = _engine()
    built = _ptrs(eng)
    eng.warmup()
    per_frame = []
    path = str(tmp_path_factory.mktemp("ckpt") / "engine.npz")
    for f in range(N_FRAMES):
        eng.process_frame(eng.upload_frame(seq["depth"][f], seq["color"][f]))
        per_frame.append(_ptrs(eng))
        if f == SAVE_AT:
            eng.save(path)
    return eng, built, per_frame, path


def test_state_keeps_its_storage_through_frames_and_boundaries(driven):
    eng, built, per_frame, _ = driven
    assert eng.num_keyframes == 2 and len(eng.boundary_stats) == 2
    # the open window's frames are recorded at its boundary
    assert eng.frame_valid == [True] * (2 * SUBMAP + 1)
    assert set(built) == set(per_frame[0]) and len(built) == 23
    for f, ptrs in enumerate(per_frame):
        moved = [k for k in built if ptrs[k] != built[k]]
        assert not moved, (f, moved)
    assert eng._graphs == {}   # the CPU runs the step eagerly


def test_loaded_engine_keeps_its_storage(driven, seq, monkeypatch):
    """``load`` copies the window, the archive and the anchor pose into the
    storages its engine was built with, and they stay through the frames
    after it (a boundary among them)."""
    _, _, _, path = driven
    built = []
    init = BundleFusion.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        built.append(_ptrs(self))

    monkeypatch.setattr(BundleFusion, "__init__", recording_init)
    eng = BundleFusion.load(path, device="cpu")
    monkeypatch.undo()
    assert len(built) == 1 and _ptrs(eng) == built[0]
    assert eng.frame_idx == SAVE_AT + 1
    for f in range(SAVE_AT + 1, N_FRAMES):
        eng.process_frame(eng.upload_frame(seq["depth"][f], seq["color"][f]))
        assert _ptrs(eng) == built[0], f
    assert eng.num_keyframes == 2


def test_rollover_keeps_the_storage_and_hands_back_the_finished_window(driven):
    eng, _, _, _ = driven
    before = _ptrs(eng)
    old = eng.local
    finished = {k: t.clone() for k, t in frame_state(eng).items()}
    eng._rollover_local()
    assert eng.local is not old and _ptrs(eng) == before
    # the object that was live holds the finished window, in copies
    for part in ("keys", "cache", "corrs"):
        obj = getattr(old, part)
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            assert t.data_ptr() != before[f"{part}.{f.name}"]
            want = finished[f"{part}.{f.name}"]
            if t.is_floating_point():
                t, want = t.nan_to_num(7.0), want.nan_to_num(7.0)
            assert torch.equal(t, want)
    assert not bool(eng.local.valid[1:].any()) and int(eng.local.corrs.count) == 0
    assert torch.equal(eng.local.keys.pos[0], finished["keys.pos"][-1])


def test_corr_store_updates_in_place():
    rng = np.random.default_rng(0)
    store = create_corr_store(64, "cpu")
    ptrs = [getattr(store, f.name).data_ptr() for f in dataclasses.fields(store)]
    for n in (20, 30, 40):   # the last one overflows
        valid = torch.from_numpy(rng.random(n) < 0.8)
        append_corrs(store, torch.full((n,), 1, dtype=torch.int32),
                     torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
                     torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
                     torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), valid)
    invalidate_frame(store, 2)
    compact_corrs(store)
    assert 0 < int(store.count) < 64
    assert ptrs == [getattr(store, f.name).data_ptr() for f in dataclasses.fields(store)]


def test_archive_slot_as_device_index_writes_the_same_frame():
    rng = np.random.default_rng(1)
    a, b = create_frame_store(4, 6, 8, "cpu"), create_frame_store(4, 6, 8, "cpu")
    d = torch.from_numpy(rng.integers(0, 65535, (6, 8)).astype(np.uint16).view(np.int16))
    c = torch.from_numpy(rng.integers(0, 255, (6, 8, 3)).astype(np.uint8))
    ptr = b.depth_mm.data_ptr()
    put_frame(a, 2, d.view(torch.uint16), c)
    put_frame(b, torch.tensor([2]), d.view(torch.uint16), c)
    assert b.depth_mm.data_ptr() == ptr
    for x, y in zip(load_frames(a, torch.arange(5)), load_frames(b, torch.arange(5))):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


# operators that make the host wait for a CUDA tensor: a value read back, a
# size that depends on the data, a LAPACK-style solve that checks its info
_WAITS = ("_local_scalar_dense", "nonzero", "eigh", "masked_select", "unique",
          "is_nonzero", "aten.equal", "linalg_solve.", "linalg_inv.", "lu_factor.",
          "cholesky.", "repeat_interleave")


class _WaitFinder(TorchDispatchMode):
    """Records every operator that would wait for the card, unless paused.
    ``lift_fresh`` of a host array (not of a 0-d scalar, which goes to the
    card as a kernel argument) is a blocking copy to the card. It sees the
    operators the step calls, not the ones they call inside: the card's own
    check is ``torch.cuda.set_sync_debug_mode("error")`` in
    ``tests/test_torch_cuda.py``."""

    def __init__(self):
        super().__init__()
        self.paused = False
        self.found = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            self.ops += 1
            name = str(func)
            waits = any(w in name for w in _WAITS)
            waits |= "lift_fresh" in name and isinstance(out, torch.Tensor) and out.dim() > 0
            # a boolean mask as an index is a nonzero inside the operator
            waits |= name.startswith("aten.index") and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple))
                          else ()))
            if waits:
                self.found.append(name)
        return out


def test_frame_step_calls_nothing_that_waits_for_the_card(seq, monkeypatch):
    eng = _engine()
    for f in range(3):
        eng._frame_step(seq["depth"][f], seq["color"][f], f, f)
    finder = _WaitFinder()

    def kernel_stand_in(fn):
        def run(*a, **kw):
            finder.paused = True
            try:
                return fn(*a, **kw)
            finally:
                finder.paused = False
        return run

    # the two filters' plain versions stand in for their kernels here
    monkeypatch.setattr(frontend, "kabsch_filter", kernel_stand_in(frontend.kabsch_filter))
    monkeypatch.setattr(frontend, "surface_area_filter",
                        kernel_stand_in(frontend.surface_area_filter))
    depth, color = eng.upload_frame(seq["depth"][3], seq["color"][3])
    slot = torch.tensor([3])
    with finder:
        T, valid = eng._frame_step(depth, color, 3, slot)
    assert finder.ops > 1000 and finder.found == []
    assert bool(valid) and T.shape == (4, 4)
