"""Shared helpers of the ``test_torch_*`` parity tests: the small
configuration, numpy views of JAX state, and a JAX-made submap window
(keypoints + dense cache of a few synthetic frames) to feed both sides."""

import jax.numpy as jnp
import numpy as np
import torch

from bundlefusion_tpu.geometry.camera import CameraIntrinsics as JaxIntrinsics
from bundlefusion_tpu.io.synthetic import default_intrinsics, make_sequence
from bundlefusion_tpu.ops import sift as jsift
from bundlefusion_tpu.ops.image import (
    erode_depth,
    resample_bilinear,
    resample_nearest,
    rgb_to_intensity,
)
from bundlefusion_tpu.pipeline import frames as jframes
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics

# The suite runs in several worker processes at once, and every worker imports
# this module while it collects: two intra-op threads each keep the workers
# from fighting over the cores (the sizes here are too small to use more).
torch.set_num_threads(2)

# the small configuration of tests/test_pipeline_e2e.py
SIFT = dict(num_octaves=3, target_keys=96, max_candidates_per_octave=256,
            min_scale=1.0, dog_thresh=0.004)
APP = dict(
    integration_width=80, integration_height=60, sdf_voxel_size=0.03,
    sdf_truncation=0.09, hash_num_sdf_blocks=8192, hash_key_capacity=16384,
    visible_blocks_cap=8192, alloc_max_new_blocks_per_frame=8192,
)
BUNDLING = dict(
    width_sift=160, height_sift=120, downsampled_width=40, downsampled_height=30,
    max_local_corr=2048, max_global_corr=8192,
    min_num_matches_local=4, min_num_matches_global=4,
)


def to_np(x):
    """A JAX array as numpy; bfloat16 widens to float32 (exactly)."""
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def fields_np(nt) -> dict:
    """A JAX NamedTuple of arrays as a dict of numpy arrays."""
    return {k: to_np(v) for k, v in nt._asdict().items()}


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def port_intr(intr) -> CameraIntrinsics:
    return CameraIntrinsics(**intr.__dict__)


def sift_inputs(n_frames: int, capacity=None):
    """(intensity [n, 120, 160], depth [n, 120, 160], intr) of the synthetic
    orbit, eroded and resampled as ``frame_step`` does."""
    intr = default_intrinsics(160, 120)
    seq = make_sequence(n_frames, intr=intr)
    inten, depth = [], []
    for i in range(n_frames):
        d = erode_depth(erode_depth(jnp.asarray(seq["depth"][i])))
        inten.append(to_np(resample_bilinear(rgb_to_intensity(jnp.asarray(seq["color"][i])),
                                             120, 160)))
        depth.append(to_np(resample_nearest(d, 120, 160)))
    return np.stack(inten), np.stack(depth), seq, intr


def jax_window(n_frames: int, capacity: int):
    """A JAX submap window holding ``n_frames`` synthetic frames in slots
    0..n-1 of stores with ``capacity`` slots: (KeyframeStore, DenseCache,
    intr_sift, intr_cache)."""
    inten, depth, seq, intr = sift_inputs(n_frames)
    cfg = jsift.SiftConfig(**SIFT)
    intr_cache = intr.scaled(40, 30)
    keys = jframes.create_keyframe_store(capacity, cfg.target_keys)
    cache = jframes.create_dense_cache(capacity, 30, 40)
    for i in range(n_frames):
        kp = jsift.detect_and_describe(jnp.asarray(inten[i]), jnp.asarray(depth[i]), cfg)
        keys = jframes.store_keypoints(keys, i, kp)
        d_int = resample_nearest(jnp.asarray(depth[i]), 60, 80)
        c_int = resample_bilinear(jnp.asarray(seq["color"][i]), 60, 80)
        cache = jframes.store_cache_frame(cache, i, d_int, c_int, intr_cache)
    return keys, cache, intr, intr_cache


def port_corrs(store, device="cpu"):
    """A JAX ``CorrStore`` carried into the port."""
    from bundlefusion_tpu_torch.solver.residuals import corr_store_from_numpy

    return corr_store_from_numpy(fields_np(store), device)


def port_cache(cache, device="cpu"):
    """A JAX ``DenseCache`` carried into the port."""
    from bundlefusion_tpu_torch.pipeline.frames import dense_cache_from_numpy

    return dense_cache_from_numpy(fields_np(cache), device)
