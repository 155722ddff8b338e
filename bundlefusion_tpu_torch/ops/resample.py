"""Projective-association sampling.

Port of ``bundlefusion_tpu/ops/resample.py``. The reference samples with two
one-hot contractions because per-pixel gathers are slow on a TPU; a CUDA
card gathers natively, so the same function here is one indexed read. Name
and contract are kept: it is used by the dense verification
(``ops/filters.py``, reference ``computeProjError``) and will be by the
dense point-to-plane term.
"""

from __future__ import annotations

import torch


def onehot_gather2d(stack: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Sample ``stack[c, vi, ui]`` for every (vi, ui).

    Args:
      stack: [C, H, W] float32 channel stack (pre-sanitized: no NaN/inf), or
        [B, C, H, W] with ``vi`` / ``ui`` / ``valid`` of shape [B, *S]: each
        batch entry samples its own stack.
      vi, ui: integer pixel indices, any shape S (in range where valid).
      valid: bool mask, shape S; invalid positions return 0.

    Returns [*S, C] (or [B, *S, C]) samples, detached from autograd:
    projective association is fixed within a Gauss-Newton iteration.
    """
    batched = stack.ndim == 4
    if not batched:
        stack, vi, ui, valid = stack[None], vi[None], ui[None], valid[None]
    B, C, H, W = stack.shape
    shape = vi.shape
    lin = torch.where(valid, vi * W + ui, 0).reshape(B, 1, -1).to(torch.int64)
    smp = torch.gather(stack.reshape(B, C, H * W), 2, lin.expand(B, C, -1))   # [B, C, P]
    out = torch.where(valid.reshape(B, -1, 1), smp.transpose(1, 2), 0.0)
    out = out.reshape(*shape, C).detach()
    return out if batched else out[0]
