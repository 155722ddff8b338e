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
