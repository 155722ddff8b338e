"""The process group the multi-device path runs over, and its collectives.

The JAX package runs one controller over a ``jax.sharding.Mesh`` and shards
compute inside explicit ``shard_map``s. The port runs one process per rank in
a ``torch.distributed`` process group, SPMD as under ``torchrun``: every rank
calls the same functions with the same arguments, holds a replica of the
replicated state, and computes its own 1/n share of the sharded work. The
collectives below are the counterparts of the ``jax.lax`` ones the JAX
modules use (``all_gather(..., tiled=True)``, ``psum``) plus the broadcast
that stands in for the JAX engine's ``device_put`` onto the mesh.

Backends: ``gloo`` (any number of ranks on one card or on the CPU) and
``nccl`` (one card per rank). Under ``gloo`` a CUDA tensor crosses through a
host copy made here; those bytes are counted in ``Mesh.stats`` beside the
bytes each collective moves. A tensor the backend cannot carry (a CPU tensor
under ``nccl``, any backend but these two) raises: no collective moves the
work to the CPU behind the caller's back.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

AXIS = "shard"
BACKENDS = ("gloo", "nccl")
# dtypes the wire carries as another dtype of the same width
_WIRE = {torch.bool: torch.uint8, torch.bfloat16: torch.int16, torch.uint16: torch.int16}


def _new_stats() -> dict:
    return {"calls": 0, "all_gather_bytes": 0, "broadcast_bytes": 0, "all_reduce_bytes": 0,
            "host_staged_bytes": 0}


@dataclass
class Mesh:
    """A 1-D mesh of ``size`` ranks over one process group: this process is
    ``rank``, its tensors live on ``device``. ``stats`` counts the
    collectives this process took part in and the bytes it sent into them
    (``host_staged_bytes``: the part that crossed through a host copy)."""

    group: Optional[object]   # a ProcessGroup; None is the default group
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = AXIS
    stats: dict = field(default_factory=_new_stats)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def reset_stats(self) -> None:
        self.stats = _new_stats()


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of an initialised ``torch.distributed`` process group (the
    default group unless ``group`` is given). ``device`` defaults to the
    current CUDA card; pass ``"cpu"`` for CPU ranks under ``gloo``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed.init_process_group first")
    backend = str(dist.get_backend(group))
    if backend not in BACKENDS:
        raise ValueError(f"make_mesh: backend {backend!r} is not one of {BACKENDS}")
    if device is None:
        from bundlefusion_tpu_torch import default_device

        default_device()  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: nccl carries CUDA tensors only")
    return Mesh(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group),
                device=device, backend=backend)


def _to_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.dtype in _WIRE:
        x = x.view(_WIRE[x.dtype])
    if x.is_cuda and mesh.backend == "gloo":
        mesh.stats["host_staged_bytes"] += x.numel() * x.element_size()
        return x.cpu()
    if not x.is_cuda and mesh.backend == "nccl":
        raise ValueError(f"nccl cannot carry a tensor on {x.device}")
    return x


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(like.device).view(like.dtype)


def _count(mesh: Mesh, kind: str, x: torch.Tensor) -> None:
    mesh.stats["calls"] += 1
    mesh.stats[kind + "_bytes"] += x.numel() * x.element_size()


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (same shape on all) concatenated along dim 0 in
    rank order: ``jax.lax.all_gather(x, axis, tiled=True)``."""
    _count(mesh, "all_gather", x)
    w = _to_wire(mesh, x)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return _from_wire(torch.cat(parts), x)


def all_reduce(mesh: Mesh, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the ranks (``jax.lax.psum`` for the default op);
    returns a new tensor."""
    _count(mesh, "all_reduce", x)
    w = _to_wire(mesh, x).clone()
    dist.all_reduce(w, op=op, group=mesh.group)
    return _from_wire(w, x)


def broadcast_tensors(mesh: Mesh, tensors: Sequence[torch.Tensor], src: int = 0
                      ) -> List[torch.Tensor]:
    """Rank ``src``'s ``tensors`` on every rank, in one collective. Every
    rank passes tensors of the same shapes and dtypes (on the other ranks
    their values are ignored: an ``empty_like`` template will do); they
    travel as one byte buffer. Returns new tensors on the other ranks and
    the inputs themselves on ``src``."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    total = sum(sizes)
    if mesh.rank == src:
        buf = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    else:
        buf = torch.empty((total,), dtype=torch.uint8, device=mesh.device)
    _count(mesh, "broadcast", buf)
    w = _to_wire(mesh, buf)
    dist.broadcast(w, src=dist.get_global_rank(mesh.group, src) if mesh.group else src,
                   group=mesh.group)
    if mesh.rank == src:
        return list(tensors)
    buf = w.to(mesh.device)
    out, off = [], 0
    for t, n in zip(tensors, sizes):
        out.append(buf[off:off + n].clone().view(t.dtype).reshape(t.shape).to(t.device))
        off += n
    return out


def barrier(mesh: Mesh) -> None:
    """All ranks reach this point before any leaves it (a 1-element
    all-reduce: the same collective on every backend and device)."""
    all_reduce(mesh, torch.zeros((1,), dtype=torch.int32, device=mesh.device))


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world_size, backend, init_method, device, args, results):
    try:
        if device is not None and torch.device(device).type == "cuda" \
                and torch.device(device).index is not None:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
        try:
            mesh = make_mesh(device=device)
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo", device=None,
              init_method: Optional[str] = None, timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` new processes, one rank
    each, and return their results in rank order.

    The processes start by ``spawn`` (a fresh interpreter: safe where the
    caller has initialised CUDA); ``fn`` must be importable by name and its
    arguments and result picklable. ``device``: each rank's device (the
    same for all: ``"cpu"``, or ``"cuda:0"`` for several ranks on one card
    under ``gloo``); None takes the card, rank r on card r under ``nccl``.
    ``init_method`` defaults to a ``file://`` store in a new temporary
    directory. Raises with the rank's traceback if any rank fails, and
    stops every process it started."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="bf_rdzv_")
        init_method = "file://" + os.path.join(tmp, "store")
    procs = []
    for rank in range(world_size):
        dev = device
        if dev is None and backend == "nccl":
            dev = f"cuda:{rank}"
        procs.append(ctx.Process(target=_rank_main, daemon=True, args=(
            fn, rank, world_size, backend, init_method, dev, args, results)))
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size and not errors:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that died without a word (killed, or failed while
                # starting) would leave the others waiting in a collective
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    errors.append(f"ranks {dead} (rank, exit code) exited without a result")
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: no result within {timeout} s") from None
                continue
            if ok:
                out[rank] = value
            else:
                # the other ranks may now wait forever in a collective
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors or len(out) < world_size else 60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if tmp is not None:
            for name in os.listdir(tmp):
                os.remove(os.path.join(tmp, name))
            os.rmdir(tmp)
    if errors:
        raise RuntimeError("run_ranks: a rank failed\n" + "\n".join(errors))
    return [out[r] for r in range(world_size)]
