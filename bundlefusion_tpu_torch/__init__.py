"""bundlefusion_tpu_torch — PyTorch + CUDA port of ``bundlefusion_tpu``.

The JAX package stays the reference; this package mirrors its subpackage
layout (``geometry``, ``io``, ``ops``, ``tsdf``, ``solver``, ``pipeline``,
``parallel``, ``utils``) and function names so each counterpart is easy to find. Plain
tensor code is PyTorch; the one Pallas kernel of the JAX package (the fused
TSDF integrate / de-integrate sweep) is three hand-written CUDA kernels for
Hopper under ``kernels/``, built with ``nvcc`` on first use; a fourth and
a fifth run the greedy Kabsch filter and the surface-area filter of the
match cascade on the card, as the reference's jitted code does. On the card
the per-frame step is captured once per window slot as a CUDA graph and
replayed each frame, the counterpart of the reference's compiled
``frame_step``.

Ported so far: the engine's main path on one device (``pipeline.online``:
SIFT frontend, match filters, correspondences, bundle adjustment and the
submap boundary, TSDF fusion with re-integration, splat render, mesh) and
the recorded-scan path (``.sens`` / TUM / binary-dump readers and the native
depth codec in ``io``, raycast ``render``, host paging of TSDF blocks,
engine checkpoints, the CLI's file inputs), the multi-device path
(``parallel``: the engine's ``mesh=`` on ``torch.distributed`` ranks, the
sharded solver and matching, sharded TSDF payload rows), the serialized
device-time replay (``profile_every``) and the correspondence evaluator
(``utils.corr_eval``).

This package imports ``torch`` and never ``jax`` or ``bundlefusion_tpu``.
"""

__version__ = "0.1.0"

import torch as _torch

# The reference forces highest-precision float32 matmuls
# (bundlefusion_tpu/__init__.py); TF32 keeps ~3 decimal digits, so it is
# off for both matmul and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def default_device() -> _torch.device:
    """The CUDA card. Entry points run there unless the caller names another
    device; without a card this raises rather than landing on the CPU."""
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "bundlefusion_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    return _torch.device("cuda")


from bundlefusion_tpu_torch.config import AppConfig, BundlingConfig  # noqa: E402,F401
from bundlefusion_tpu_torch.geometry.camera import CameraIntrinsics  # noqa: E402,F401
from bundlefusion_tpu_torch.ops.sift import SiftConfig  # noqa: E402,F401
