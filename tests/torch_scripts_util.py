"""Shared by the tests of ``bundlefusion_tpu_torch.scripts``: a record of
the places in the checkout a script could write to, to show that a run with
``--out`` wrote nowhere else."""

import os

import torch

# as tests/torch_parity.py: the suite runs several worker processes at once,
# and a worker with more intra-op threads than its share of the cores runs
# these small renders and solves many times slower
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the root's files, where the JAX scripts write their JSON, and the
# directories the port's scripts default to
WATCHED = ("", "chiprun_out", os.path.join("chiprun_out", "scripts"), "seq_cache",
           os.path.join("tests", "fixtures"))


def snapshot() -> dict:
    """{path: (size, mtime)} of the files in the watched directories."""
    out = {}
    for d in WATCHED:
        full = os.path.join(ROOT, d)
        if not os.path.isdir(full):
            continue
        for name in os.listdir(full):
            p = os.path.join(full, name)
            if os.path.isfile(p):
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns)
    return out


def outside_writes(before: dict) -> list:
    """Files of the watched directories created or changed since ``before``."""
    after = snapshot()
    return sorted(p for p, v in after.items() if before.get(p) != v)
