"""Host-side helpers: metrics, timing, and carrying numpy state in."""

from dataclasses import fields

import numpy as np
import torch


def owned_tensor(array, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor on ``device`` holding its own copy of a numpy array (which
    may be read-only, or a view of another framework's buffer): the stores
    are updated in place and must not write through to the source."""
    return torch.from_numpy(np.array(array)).to(device=device, dtype=dtype)


def dataclass_from_numpy(cls, arrays: dict, dtypes: dict, device):
    """Build a store dataclass from a dict of numpy arrays keyed by field
    name, cast to ``dtypes`` and copied to ``device``."""
    return cls(**{f.name: owned_tensor(arrays[f.name], dtypes[f.name], device)
                  for f in fields(cls)})


def copy_into(dst, src) -> None:
    """Copy a (nested) dataclass of tensors into another of the same
    shapes, tensor by tensor and in place: ``dst`` keeps its storages (a
    captured CUDA graph reads and writes them by address)."""
    for f in fields(dst):
        d, s = getattr(dst, f.name), getattr(src, f.name)
        if isinstance(d, torch.Tensor):
            d.copy_(s)
        else:
            copy_into(d, s)


# Device -> host reads made by data-dependent branches (each is a wait for
# the card). Code that branches on a tensor's value reads it through
# ``read_host`` so a caller can count the waits of a stage.
host_reads = {"count": 0}


def read_host(x: torch.Tensor):
    """The value(s) of a small tensor as Python numbers; counted."""
    host_reads["count"] += 1
    return x.tolist()


def read_host_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array on the host; counted."""
    host_reads["count"] += 1
    return x.cpu().numpy()


def segment_sum_sorted(vals: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    """Sum the rows of ``vals`` [c, D] over runs of equal ids: ``seg_ids``
    [c] is ascending with values in [0, num_segments). Returns
    [num_segments, D]. Each segment is summed front to back by one thread,
    with no atomics, so the result repeats bit for bit on the card."""
    out_shape = (num_segments, *vals.shape[1:])
    if vals.shape[0] == 0:
        return vals.new_zeros(out_shape)
    edges = torch.arange(num_segments + 1, dtype=seg_ids.dtype, device=seg_ids.device)
    bounds = torch.searchsorted(seg_ids.contiguous(), edges)
    return torch.segment_reduce(vals.contiguous(), "sum", lengths=bounds.diff(), axis=0,
                                unsafe=True)


def onehot_sum(vals: torch.Tensor, idx: torch.Tensor, num_rows: int):
    """Sum the rows of ``vals`` [P, ...] into ``num_rows`` rows by ``idx``
    [P] (entries outside [0, num_rows) take no part) as one [num_rows, P]
    one-hot product: an ordered reduction for small P, repeatable where a
    scatter-add with repeated indices is not."""
    rows = torch.arange(num_rows, device=idx.device)
    onehot = (rows[:, None] == idx[None, :]).to(vals.dtype)
    return (onehot @ vals.reshape(vals.shape[0], -1)).reshape(num_rows, *vals.shape[1:])
