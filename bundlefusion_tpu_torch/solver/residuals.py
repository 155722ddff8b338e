"""Sparse 3D-3D correspondence store (the EntryJ equivalent).

Port of ``bundlefusion_tpu/solver/residuals.py``: a fixed-capacity
structure-of-arrays of ``EntryJ{imgIdx_i, imgIdx_j, pos_i, pos_j}`` residuals
built from filtered SIFT matches, with -1 image indices marking invalid
entries. The store is updated in place, into the tensors it was made with,
so a captured frame graph keeps writing where it did; the append cursor
``count`` is a 0-d tensor on the device, so appending reads nothing back.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bundlefusion_tpu_torch.utils import dataclass_from_numpy


@dataclass
class CorrStore:
    img_i: torch.Tensor   # int32 [C], -1 = invalid
    img_j: torch.Tensor   # int32 [C]
    p_i: torch.Tensor     # float32 [C, 3] camera-space point in frame i
    p_j: torch.Tensor     # float32 [C, 3] camera-space point in frame j
    key_i: torch.Tensor   # int32 [C] flat keypoint id (slot * K + key index),
                          # used by track-based keyframe fusion
    key_j: torch.Tensor   # int32 [C]
    count: torch.Tensor   # int32 [] append cursor (entries may be invalidated)

    @property
    def capacity(self) -> int:
        return self.img_i.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return self.img_i >= 0


_DTYPES = {"img_i": torch.int32, "img_j": torch.int32, "p_i": torch.float32,
           "p_j": torch.float32, "key_i": torch.int32, "key_j": torch.int32,
           "count": torch.int32}


def create_corr_store(capacity: int, device) -> CorrStore:
    def z(shape, dt, fill=0):
        return torch.full(shape, fill, dtype=dt, device=device)

    return CorrStore(
        img_i=z((capacity,), torch.int32, -1),
        img_j=z((capacity,), torch.int32, -1),
        p_i=z((capacity, 3), torch.float32),
        p_j=z((capacity, 3), torch.float32),
        key_i=z((capacity,), torch.int32),
        key_j=z((capacity,), torch.int32),
        count=z((), torch.int32),
    )


def corr_store_from_numpy(arrays: dict, device) -> CorrStore:
    """A store holding the given arrays (keys: the field names)."""
    return dataclass_from_numpy(CorrStore, arrays, _DTYPES, device)


def _valid_first(valid: torch.Tensor) -> torch.Tensor:
    """Indices with the valid entries first, in their original order."""
    return torch.sort((~valid).to(torch.int8), stable=True).indices


def append_corrs(store: CorrStore, img_i, img_j, p_i, p_j, valid,
                 key_i=None, key_j=None) -> CorrStore:
    """Append a batch of correspondences at the cursor, in place (mirrors
    ``AddCurrToResidualsCU``). Invalid entries are compacted out before
    appending; what does not fit is dropped.

    The r-th valid entry lands at ``count + r``. That is written here from
    the store's side, as a masked select over all of its rows: row c takes
    entry ``c - count`` of the compacted batch if there is one. So nothing
    is scattered, no spare row is needed for dropped writes, and the batch
    size is never read back to the host.
    """
    C = store.capacity
    order = _valid_first(valid)
    n_valid = valid.sum()
    r = torch.arange(C, device=valid.device) - store.count
    take = (r >= 0) & (r < n_valid)
    src = order[torch.clamp(r, 0, order.shape[0] - 1)]
    if key_i is None:
        key_i = torch.zeros_like(img_i)
    if key_j is None:
        key_j = torch.zeros_like(img_j)
    new = {"img_i": img_i, "img_j": img_j, "p_i": p_i, "p_j": p_j, "key_i": key_i,
           "key_j": key_j}
    for name, vals in new.items():
        old = getattr(store, name)
        m = take if old.ndim == 1 else take[:, None]
        old.copy_(torch.where(m, vals[src].to(old.dtype), old))
    store.count.add_(torch.clamp(n_valid, max=C - store.count).to(torch.int32))
    return store


def invalidate_image_pair(store: CorrStore, frame_a, frame_b) -> CorrStore:
    """Invalidate all corrs between a specific image pair (reference
    ``InvalidateImageToImageCU``), in place."""
    kill = ((store.img_i == frame_a) & (store.img_j == frame_b)) | (
        (store.img_i == frame_b) & (store.img_j == frame_a)
    )
    store.img_i.masked_fill_(kill, -1)
    return store


def invalidate_frame(store: CorrStore, frame) -> CorrStore:
    """Invalidate all corrs touching a frame, in place."""
    kill = (store.img_i == frame) | (store.img_j == frame)
    store.img_i.masked_fill_(kill, -1)
    return store


def corr_counts_per_frame(store: CorrStore, num_frames: int) -> torch.Tensor:
    """Number of valid corrs per frame (reference ``CheckForInvalidFrames``
    invalidates frames left without correspondences)."""
    v = store.valid_mask()
    # invalid or out-of-range entries count into a spare last cell
    seg = torch.stack([store.img_i, store.img_j]).to(torch.int64)
    seg = torch.where(v[None] & (seg < num_frames), seg, num_frames).reshape(-1)
    c = torch.zeros(num_frames + 1, dtype=torch.int32, device=seg.device)
    c.index_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))
    return c[:num_frames]


def compact_corrs(store: CorrStore) -> CorrStore:
    """Reclaim invalidated slots, in place: stable-compact the live rows to
    a prefix, clear the tail, drop the cursor to the live count. Callers
    run this when ``count`` approaches capacity (the reference's store is
    append-only and leaks capacity under heavy pruning)."""
    C = store.capacity
    v = store.valid_mask()
    n_live = v.sum()
    ci = _valid_first(v)
    ok = torch.arange(C, device=v.device) < n_live
    for name, fill in (("img_i", -1), ("img_j", -1), ("p_i", 0.0), ("p_j", 0.0),
                       ("key_i", -1), ("key_j", -1)):
        old = getattr(store, name)
        m = ok if old.ndim == 1 else ok[:, None]
        old.copy_(torch.where(m, old[ci], fill))
    store.count.copy_(n_live)
    return store
