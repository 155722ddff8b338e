"""Per-frame device state: dense cache, keypoint store, frame archive.

Port of ``bundlefusion_tpu/pipeline/frames.py``: ``DenseCache`` (the
reference's ``CUDACache``: downsampled depth, camera-space positions,
normals, intensity per frame), ``KeyframeStore`` (``SIFTImageManager``'s
per-image keypoint / descriptor arrays) and ``FrameStore`` with its wire
codec. All three are dataclasses of fixed-capacity tensors indexed by frame
slot and are updated in place (the JAX versions return new stores).

Archived frames live on the device in the compact wire encoding
(uint16 mm depth + uint8 color, the .sens on-disk representation) and are
gathered by index when a frame is de- or re-integrated. The last slot is a
scratch slot for frames beyond capacity. ``store_frame`` writes the slot in
place (the JAX version returns a new store).

PyTorch implements few operations for ``uint16`` (no indexing on the card,
no comparisons), so the depth codes move through ``int16`` views of the
same bits: casts to and from ``int16`` wrap modulo 2^16.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics, unproject
from bundlefusion_tpu_torch.ops.image import (
    bilateral_filter_depth,
    compute_normals,
    resample_bilinear,
    resample_nearest,
    rgb_to_intensity,
)
from bundlefusion_tpu_torch.ops.sift import SiftKeypoints
from bundlefusion_tpu_torch.utils import dataclass_from_numpy


@dataclass
class DenseCache:
    """Downsampled per-frame geometry for dense verify / dense BA."""

    depth: torch.Tensor       # [F, h, w]
    campos: torch.Tensor      # [F, h, w, 3]
    normal: torch.Tensor      # [F, h, w, 3]
    intensity: torch.Tensor   # [F, h, w]

    @property
    def capacity(self) -> int:
        return self.depth.shape[0]


def create_dense_cache(capacity: int, h: int, w: int, device) -> DenseCache:
    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return DenseCache(
        depth=full((capacity, h, w), torch.nan),
        campos=full((capacity, h, w, 3), torch.nan),
        normal=full((capacity, h, w, 3), torch.nan),
        intensity=full((capacity, h, w), 0.0),
    )


def dense_cache_from_numpy(arrays: dict, device) -> DenseCache:
    """A cache holding the given arrays (keys: the field names)."""
    dtypes = dict.fromkeys(("depth", "campos", "normal", "intensity"), torch.float32)
    return dataclass_from_numpy(DenseCache, arrays, dtypes, device)


def make_cache_frame(depth, color, intr_small: CameraIntrinsics,
                     sigma_d: float = 1.0, sigma_r: float = 0.05):
    """One cache entry from (integration-res) depth + color, mirroring
    ``CUDACache::storeFrame``: bilateral-filter depth -> downsample ->
    camera-space positions -> normals -> intensity."""
    h, w = intr_small.height, intr_small.width
    d = bilateral_filter_depth(depth, sigma_d, sigma_r)
    d_small = resample_nearest(d, h, w)
    campos = unproject(d_small, intr_small)
    normal = compute_normals(campos)
    inten = resample_bilinear(rgb_to_intensity(color), h, w)
    return d_small, campos, normal, inten


def store_cache_frame(cache: DenseCache, slot: int, depth, color, intr_small) -> DenseCache:
    """Compute and write one cache entry into ``slot`` (in place)."""
    d, cp, n, i = make_cache_frame(depth, color, intr_small)
    cache.depth[slot] = d
    cache.campos[slot] = cp
    cache.normal[slot] = n
    cache.intensity[slot] = i
    return cache


def copy_cache_frame(dst: DenseCache, dst_slot: int, src: DenseCache, src_slot: int) -> DenseCache:
    """``CUDACache::copyCacheFrameFrom`` (submap frame 0 -> keyframe cache),
    in place on ``dst``."""
    for f in fields(DenseCache):
        getattr(dst, f.name)[dst_slot] = getattr(src, f.name)[src_slot]
    return dst


@dataclass
class FrameStore:
    depth_mm: torch.Tensor  # [F+1, h, w] uint16 (0 = invalid)
    color: torch.Tensor     # [F+1, h, w, 3] uint8

    @property
    def capacity(self) -> int:
        """Number of addressable (re-integrable) frames."""
        return self.depth_mm.shape[0] - 1


def create_frame_store(capacity: int, h: int, w: int, device) -> FrameStore:
    return FrameStore(
        depth_mm=torch.zeros((capacity + 1, h, w), dtype=torch.int16,
                             device=device).view(torch.uint16),
        color=torch.zeros((capacity + 1, h, w, 3), dtype=torch.uint8, device=device),
    )


def encode_frame(depth: torch.Tensor, color: torch.Tensor):
    """float32 (meters, [0,1] rgb) -> wire encoding (uint16 mm, uint8)."""
    d = torch.where(
        torch.isfinite(depth), torch.clamp(depth * 1000.0 + 0.5, 0, 65535), 0.0
    )
    # float -> int truncates toward zero; the values are non-negative, so
    # this is the same conversion as the reference's astype
    d_mm = d.to(torch.int32).to(torch.int16).view(torch.uint16)
    c_u8 = torch.clamp(color * 255.0 + 0.5, 0, 255).to(torch.uint8)
    return d_mm, c_u8


def decode_frame(d_mm: torch.Tensor, c_u8: torch.Tensor):
    """Exact inverse of :func:`encode_frame` for mm-quantized depth — the
    de-integration path must subtract bitwise-identical values."""
    d = d_mm.view(torch.int16).to(torch.int32) & 0xFFFF
    depth = torch.where(d > 0, d.to(torch.float32) * 1e-3, torch.nan)
    color = c_u8.to(torch.float32) * (1.0 / 255.0)
    return depth, color


def load_frames(store: FrameStore, fids: torch.Tensor):
    """Gather archived frames by index -> (depth_mm [K, h, w], color [K, h, w, 3])."""
    d_mm = store.depth_mm.view(torch.int16)[fids].view(torch.uint16)
    return d_mm, store.color[fids]


def put_frame(store: FrameStore, slot, d_mm: torch.Tensor, c_u8: torch.Tensor) -> None:
    """Write one encoded frame into ``slot`` (in place): a host int, or an
    int64 index tensor of one element on the store's device (read on the
    device, so a captured frame graph can take a new slot at each replay)."""
    if isinstance(slot, torch.Tensor):
        idx = slot.reshape(1)
        store.depth_mm.view(torch.int16).index_copy_(0, idx, d_mm.view(torch.int16)[None])
        store.color.index_copy_(0, idx, c_u8[None])
        return
    store.depth_mm.view(torch.int16)[slot] = d_mm.view(torch.int16)
    store.color[slot] = c_u8


def store_frame(store: FrameStore, slot: int, depth, color) -> FrameStore:
    """Encode one frame into ``slot`` (in place) and return the store."""
    put_frame(store, slot, *encode_frame(depth, color))
    return store


@dataclass
class KeyframeStore:
    """Fixed-capacity keypoint/descriptor store over frames
    (SIFTImageManager's per-image arrays, structure-of-arrays form)."""

    pos: torch.Tensor          # [F, K, 2]
    scale: torch.Tensor        # [F, K]
    depth: torch.Tensor        # [F, K]
    response: torch.Tensor     # [F, K]
    valid: torch.Tensor        # [F, K] bool
    desc: torch.Tensor         # [F, K, 128] bfloat16 (halves the footprint)
    frame_valid: torch.Tensor  # [F] bool: frame participates in matching

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def keys_per_frame(self) -> int:
        return self.pos.shape[1]


_KEY_DTYPES = {"pos": torch.float32, "scale": torch.float32, "depth": torch.float32,
               "response": torch.float32, "valid": torch.bool, "desc": torch.bfloat16,
               "frame_valid": torch.bool}


def create_keyframe_store(capacity: int, keys_per_frame: int, device) -> KeyframeStore:
    shapes = {"pos": (keys_per_frame, 2), "desc": (keys_per_frame, 128), "frame_valid": ()}
    return KeyframeStore(**{
        name: torch.zeros((capacity, *shapes.get(name, (keys_per_frame,))), dtype=dt,
                          device=device)
        for name, dt in _KEY_DTYPES.items()
    })


def keyframe_store_from_numpy(arrays: dict, device) -> KeyframeStore:
    """A store holding the given arrays (keys: the field names). Descriptors
    arrive as float32 and are rounded to bfloat16, to nearest even."""
    return dataclass_from_numpy(KeyframeStore, arrays, _KEY_DTYPES, device)


def store_keypoints(store: KeyframeStore, slot: int, kp: SiftKeypoints) -> KeyframeStore:
    """Insert a detection result (possibly fewer keys than the store's
    width; the rest of the slot is cleared) in place."""
    k = kp.pos.shape[0]
    for name in ("pos", "scale", "depth", "response", "valid", "desc"):
        row = getattr(store, name)[slot]
        row[:k] = getattr(kp, name)     # desc: cast to bfloat16 by the copy
        if k < row.shape[0]:
            row[k:] = 0
    store.frame_valid[slot] = kp.valid.any()
    return store


def backproject_keys(pos, depth, intr: CameraIntrinsics):
    """Keypoint pixel+depth -> camera-space 3D (the reference back-projects
    via colorIntrinsicsInv in ``getKeySourceAndTargetPoints``)."""
    x = (pos[..., 0] - intr.cx) / intr.fx * depth
    y = (pos[..., 1] - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], -1)
