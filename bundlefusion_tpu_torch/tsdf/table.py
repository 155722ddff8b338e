"""Block-sparse TSDF voxel table: a sorted key table over voxel-block rows.

Port of ``bundlefusion_tpu/tsdf/table.py``. The design is the reference's: ``keys`` is a sorted
int32 array of packed block coordinates with ``EMPTY_KEY`` (int32 max)
padding, ``slots`` maps each key to its payload row, lookup is a binary
search, allocation is run-dedup + pop from a free-list stack + re-sort.
Payload per block (8^3 voxels): ``sdf``, ``weight`` and channel-major
``color`` premultiplied by weight, with one extra zero **dummy row** at
index ``num_blocks``.

PyTorch idiom: ``VoxelBlockTable`` is a dataclass of tensors and the
operations update its tensors **in place** and return the same object
(the JAX functions return a new table). Allocation and freeing write into
the tensors' own storages, so a table keeps every storage for its life (a
captured CUDA graph reads and writes them by address); ``defrag_prefix``,
which no engine path calls, still rebinds some. JAX's out-of-range
``mode="drop"`` scatters are written with a drop slot: an out-of-range target is routed
to a spare index (the dummy row, or one padding element) whose content is
restored or discarded, because ``index_put_`` would raise on the CPU and
write out of bounds on the card. Scalars (``free_count``,
``num_alloc_failures``, ``high_water``) are 0-dim int32 tensors on the
table's device, so no operation here waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

BLOCK_SIZE = 8  # voxels per side (SDF_BLOCK_SIZE)
BLOCK_VOLUME = BLOCK_SIZE**3
GRID_BITS = 10  # 1024 blocks per axis
GRID_DIM = 1 << GRID_BITS
GRID_HALF = GRID_DIM // 2
EMPTY_KEY = 2**31 - 1
ROW_ALIGN = 128  # payload rows are rounded up to this (reference tile size)
ALLOC_COMPACT = 6144  # deduped-candidate capacity per allocate() call
FREE_COMPACT = 2048  # max slots whose payload is zeroed per free_blocks call
SLOT_GEO_LANES = 4  # block coords (lanes 0-2) + live flag (lane 3)


@dataclass
class VoxelBlockTable:
    keys: torch.Tensor        # int32[capacity], sorted, EMPTY_KEY padded
    slots: torch.Tensor       # int32[capacity], payload row per key
    sdf: torch.Tensor         # float32[num_blocks + 1, 512] (+1 dummy row)
    weight: torch.Tensor      # float32[num_blocks + 1, 512]
    color: torch.Tensor       # float32[num_blocks + 1, 1536] r | g | b, premultiplied
    free_list: torch.Tensor   # int32[num_blocks] stack of free slots
    free_count: torch.Tensor  # int32[] number of free slots
    num_alloc_failures: torch.Tensor  # int32[] overflow accounting
    slot_keys: torch.Tensor   # int32[num_blocks + 1] packed coords per slot
    slot_geo: torch.Tensor    # float32[num_blocks + 1, 4] coords + live flag
    high_water: torch.Tensor  # int32[] upper bound on occupied slot indices

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.sdf.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def clone(self) -> "VoxelBlockTable":
        return VoxelBlockTable(
            **{f.name: getattr(self, f.name).clone() for f in fields(self)}
        )


def create_table(capacity: int, num_blocks: int, device) -> VoxelBlockTable:
    """Empty table; ``num_blocks`` rounds up to a multiple of 128 so every
    array shape matches the reference's."""
    num_blocks = ((num_blocks + ROW_ALIGN - 1) // ROW_ALIGN) * ROW_ALIGN

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return VoxelBlockTable(
        keys=torch.full((capacity,), EMPTY_KEY, dtype=torch.int32, device=device),
        slots=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        sdf=torch.zeros((num_blocks + 1, BLOCK_VOLUME), dtype=torch.float32, device=device),
        weight=torch.zeros((num_blocks + 1, BLOCK_VOLUME), dtype=torch.float32, device=device),
        color=torch.zeros((num_blocks + 1, 3 * BLOCK_VOLUME), dtype=torch.float32, device=device),
        # pops take the TOP of the stack; descending init hands out slots
        # 0, 1, 2, ... so occupancy stays a compact prefix
        free_list=torch.arange(num_blocks - 1, -1, -1, dtype=torch.int32, device=device),
        free_count=i32(num_blocks),
        num_alloc_failures=i32(0),
        slot_keys=torch.full((num_blocks + 1,), EMPTY_KEY, dtype=torch.int32, device=device),
        slot_geo=torch.zeros((num_blocks + 1, SLOT_GEO_LANES), dtype=torch.float32, device=device),
        high_water=i32(0),
    )


def color_at(table: VoxelBlockTable, slot, lin):
    """Premultiplied RGB at (block slot, linear voxel index) -> [..., 3]."""
    return torch.stack(
        [
            table.color[slot, lin],
            table.color[slot, BLOCK_VOLUME + lin],
            table.color[slot, 2 * BLOCK_VOLUME + lin],
        ],
        dim=-1,
    )


def pack_block_coords(coords: torch.Tensor) -> torch.Tensor:
    """int32 block coords [..., 3] -> packed int32 key (30 bits);
    out-of-range coords map to EMPTY_KEY."""
    c = coords.to(torch.int32) + GRID_HALF
    in_range = torch.all((c >= 0) & (c < GRID_DIM), dim=-1)
    packed = (c[..., 2] << (2 * GRID_BITS)) | (c[..., 1] << GRID_BITS) | c[..., 0]
    return torch.where(in_range, packed, EMPTY_KEY).to(torch.int32)


def unpack_key(key: torch.Tensor) -> torch.Tensor:
    """Packed key -> int32 block coords [..., 3] (EMPTY yields garbage)."""
    x = (key & (GRID_DIM - 1)) - GRID_HALF
    y = ((key >> GRID_BITS) & (GRID_DIM - 1)) - GRID_HALF
    z = ((key >> (2 * GRID_BITS)) & (GRID_DIM - 1)) - GRID_HALF
    return torch.stack([x, y, z], -1)


def world_to_voxel(pts, voxel_size: float):
    return pts / voxel_size


def voxel_to_block(voxel_coords_int: torch.Tensor):
    """Integer voxel coords -> (block coords, local voxel index)."""
    block = torch.div(voxel_coords_int, BLOCK_SIZE, rounding_mode="floor")
    local = voxel_coords_int - block * BLOCK_SIZE
    lin = (local[..., 2] * BLOCK_SIZE + local[..., 1]) * BLOCK_SIZE + local[..., 0]
    return block, lin


def block_to_world(block_coords: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Block coords -> world position of the block corner."""
    return block_coords.to(torch.float32) * (BLOCK_SIZE * voxel_size)


def lookup_packed(table: VoxelBlockTable, packed_keys: torch.Tensor) -> torch.Tensor:
    """packed keys [...] -> voxel slots [...], -1 where absent."""
    pos = torch.searchsorted(table.keys, packed_keys.contiguous())
    pos = torch.clamp(pos, 0, table.capacity - 1)
    found = (table.keys[pos] == packed_keys) & (packed_keys != EMPTY_KEY)
    return torch.where(found, table.slots[pos], -1)


def lookup_blocks(table: VoxelBlockTable, block_coords: torch.Tensor) -> torch.Tensor:
    return lookup_packed(table, pack_block_coords(block_coords))


def _unique_sorted_mask(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Mask of first occurrences in a sorted key array (EMPTY excluded)."""
    prev = torch.cat([sorted_keys.new_full((1,), -1), sorted_keys[:-1]])
    return (sorted_keys != prev) & (sorted_keys != EMPTY_KEY)


def _cumrank(mask: torch.Tensor) -> torch.Tensor:
    """0-based running count of True entries (cumsum - 1) as int64."""
    return torch.cumsum(mask.to(torch.int64), 0) - 1


def _scatter_drop_small(dst: torch.Tensor, idx: torch.Tensor, src) -> None:
    """``dst[idx] = src`` in place with JAX ``mode="drop"`` semantics for
    ``idx >= len(dst)``: writes go to one padding element past the end of a
    temporary copy. Only for small arrays (it copies ``dst``)."""
    n = dst.shape[0]
    tmp = torch.cat([dst, dst[:1]])
    tmp[torch.clamp(idx.to(torch.int64), max=n)] = src
    dst.copy_(tmp[:n])


def allocate(table: VoxelBlockTable, candidate_coords, valid_mask) -> VoxelBlockTable:
    """Insert candidate blocks (dedup, skip existing). See allocate_packed."""
    packed_all = torch.where(valid_mask, pack_block_coords(candidate_coords), EMPTY_KEY)
    return allocate_packed(table, packed_all.to(torch.int32))


def allocate_packed(
    table: VoxelBlockTable, packed_all: torch.Tensor, compact: int = ALLOC_COMPACT,
    blocked: torch.Tensor | None = None,
) -> VoxelBlockTable:
    """Insert candidate blocks given as packed keys [M] (EMPTY = invalid).

    Run-dedup + compact the candidates (survivors beyond ``compact`` are
    deferred), pop free slots for keys not yet present, merge by a stable
    re-sort. Overflow (free list exhausted or key capacity full) is counted
    in ``num_alloc_failures``. The merge always runs: with nothing missing
    it leaves every array as it was, which spares the reference's
    ``lax.cond`` and a wait for the device. Updates ``table`` in place.

    ``blocked``: optional ascending int32 [B] of the packed keys paged out
    to the host (``EMPTY_KEY`` padded), the ``isSDFBlockStreamedOut``
    analog: a candidate that matches one is dropped instead of being
    allocated empty, which would fork the block from its host copy.
    """
    dev = table.device
    packed_all = packed_all.to(torch.int32)
    prev = torch.cat([packed_all.new_full((1,), -1), packed_all[:-1]])
    keep = (packed_all != prev) & (packed_all != EMPTY_KEY)
    cpos = _cumrank(keep)
    M = compact
    packed_raw = torch.full((M + 1,), EMPTY_KEY, dtype=torch.int32, device=dev)
    packed_raw[torch.where(keep & (cpos < M), cpos, M)] = packed_all
    packed_raw = packed_raw[:M]
    if blocked is not None:
        bpos = torch.clamp(torch.searchsorted(blocked, packed_raw), 0, blocked.shape[0] - 1)
        hit = (blocked[bpos] == packed_raw) & (packed_raw != EMPTY_KEY)
        packed_raw = torch.where(hit, EMPTY_KEY, packed_raw).to(torch.int32)

    num_blocks = table.free_list.shape[0]
    cap = table.capacity
    keys0, slots0 = table.keys, table.slots
    free_count0 = table.free_count.to(torch.int64)

    packed = torch.sort(packed_raw).values
    uniq = _unique_sorted_mask(packed)
    pos = torch.clamp(torch.searchsorted(keys0, packed), 0, cap - 1)
    existing = (keys0[pos] == packed) & (packed != EMPTY_KEY)
    is_new = uniq & ~existing
    num_new_req = torch.sum(is_new.to(torch.int64))
    rank = _cumrank(is_new)
    num_new = torch.minimum(num_new_req, free_count0)
    can_alloc = is_new & (rank < num_new)
    take_pos = free_count0 - 1 - rank
    new_slot = torch.where(
        can_alloc, table.free_list[torch.clamp(take_pos, 0, num_blocks - 1)], -1
    ).to(torch.int32)
    new_keys = torch.where(can_alloc, packed, EMPTY_KEY).to(torch.int32)
    all_keys = torch.cat([keys0, new_keys])
    all_slots = torch.cat([slots0, new_slot])
    all_keys_sorted, order = torch.sort(all_keys, stable=True)
    dropped = torch.sum((all_keys_sorted[cap:] != EMPTY_KEY).to(torch.int64))
    fails = table.num_alloc_failures + (num_new_req - num_new) + dropped
    hw = torch.maximum(
        table.high_water,
        torch.max(torch.where(can_alloc, new_slot + 1, 0)).to(torch.int32),
    )
    table.keys.copy_(all_keys_sorted[:cap])
    table.slots.copy_(all_slots[order][:cap])
    table.free_count.copy_(free_count0 - num_new)
    table.num_alloc_failures.copy_(fails)
    table.high_water.copy_(hw)

    # slot-major inverse map + per-slot geometry rows. Rows not allocated
    # are routed to the dummy row N, whose content is restored after.
    N = table.num_blocks
    scatter_to = torch.where(can_alloc, new_slot, N).to(torch.int64)
    table.slot_keys[scatter_to] = packed
    # fills: a host scalar set into one element would be copied to the card
    table.slot_keys[N:].fill_(EMPTY_KEY)
    geo_rows = torch.cat(
        [
            unpack_key(packed).to(torch.float32),
            torch.ones((packed.shape[0], 1), dtype=torch.float32, device=dev),
        ],
        dim=1,
    )
    table.slot_geo[scatter_to] = geo_rows
    table.slot_geo[N:].zero_()
    return table


def free_blocks(table: VoxelBlockTable, free_mask: torch.Tensor) -> VoxelBlockTable:
    """Free all keys where ``free_mask`` [capacity] is True: mark them
    EMPTY, push their slots onto the free list, re-sort, and zero the freed
    payload rows (at most ``FREE_COMPACT`` per call; the rest keep stale
    payload and count in ``num_alloc_failures``). In place."""
    free_mask = free_mask & (table.keys != EMPTY_KEY)
    num_free = torch.sum(free_mask.to(torch.int64))
    N = table.num_blocks
    slots0 = table.slots
    rank = _cumrank(free_mask)

    push_pos = table.free_count.to(torch.int64) + rank
    _scatter_drop_small(
        table.free_list,
        torch.where(free_mask, push_pos, table.free_list.shape[0]),
        torch.where(free_mask, slots0, -1).to(torch.int32),
    )
    keys = torch.where(free_mask, EMPTY_KEY, table.keys).to(torch.int32)
    slots = torch.where(free_mask, -1, slots0).to(torch.int32)
    keys_sorted, order = torch.sort(keys, stable=True)

    # zero the freed slots' payload (compacted rows; the pad and the
    # overflow route to the dummy row N, which stays zero)
    freed = torch.full((FREE_COMPACT + 1,), N, dtype=torch.int64, device=table.device)
    freed[torch.where(free_mask & (rank < FREE_COMPACT), rank, FREE_COMPACT)] = torch.where(
        free_mask, slots0.to(torch.int64), N
    )
    freed = freed[:FREE_COMPACT]
    for name in ("sdf", "weight", "color"):
        getattr(table, name).index_fill_(0, freed, 0.0)
    uncleared = torch.clamp(num_free - FREE_COMPACT, min=0)
    # every freed slot leaves the slot-major inverse map (the dummy row N
    # already holds EMPTY_KEY / zeros, so routing the rest there is inert)
    freed_to = torch.where(free_mask, slots0.to(torch.int64), N)
    table.slot_keys.index_fill_(0, freed_to, EMPTY_KEY)
    table.slot_geo.index_fill_(0, freed_to, 0.0)

    table.keys.copy_(keys_sorted)
    table.slots.copy_(slots[order])
    table.free_count.copy_(table.free_count + num_free)
    table.num_alloc_failures.copy_(table.num_alloc_failures + uncleared)
    return table


def defrag_prefix(table: VoxelBlockTable, window: int) -> VoxelBlockTable:
    """Sort the first ``window`` payload rows by packed block key, in place.

    Key-sorting the payload compacts the live rows of the window into a
    dense prefix (packed key = z | y | x, x fastest). Rows at ``window`` and
    beyond keep their keys, slots and free entries. Dead rows of the window
    are zeroed, which also clears stale payload left by frees beyond
    ``FREE_COMPACT``. Not wired into the engine (nor is it in the
    reference)."""
    N = table.num_blocks
    window = min(window, N)
    if window <= 0:
        return table
    dev = table.device
    sk = table.slot_keys[:window]
    order = torch.argsort(sk, stable=True)      # EMPTY (int32 max) sorts last
    sk_sorted = sk[order]
    live_sorted = sk_sorted != EMPTY_KEY
    n_live = torch.sum(live_sorted.to(torch.int64))

    # payload rows gathered into key order; dead rows zero
    lf = live_sorted[:, None].to(torch.float32)
    for name in ("sdf", "weight", "color", "slot_geo"):
        arr = getattr(table, name)
        arr[:window] = arr[:window][order] * lf
    any_beyond = torch.any(table.slot_keys[window:N] != EMPTY_KEY)
    table.slot_keys[:window] = torch.where(live_sorted, sk_sorted, EMPTY_KEY)

    # a key whose slot was inside the window moves to its rank among the
    # window's live keys (sk_sorted is unique ascending)
    in_window = (table.slots >= 0) & (table.slots < window) & (table.keys != EMPTY_KEY)
    new_pos = torch.clamp(torch.searchsorted(sk_sorted, table.keys), 0, window - 1)
    table.slots = torch.where(in_window, new_pos, table.slots).to(torch.int32)

    # free list: window slots [n_live, window) are the free ones now; free
    # slots >= window keep the bottom of the stack, the window's go on top,
    # descending so slot n_live pops first
    fl0 = table.free_list
    idx = torch.arange(fl0.shape[0], dtype=torch.int64, device=dev)
    big = (idx < table.free_count.to(torch.int64)) & (fl0 >= window)
    n_big = torch.sum(big.to(torch.int64))
    fl = torch.full_like(fl0, -1)
    _scatter_drop_small(fl, torch.where(big, _cumrank(big), N), torch.where(big, fl0, -1))
    new_fc = n_big + (window - n_live)
    in_small = (idx >= n_big) & (idx < new_fc)
    table.free_list = torch.where(in_small, window - 1 - (idx - n_big), fl).to(torch.int32)
    table.free_count = new_fc.to(torch.int32)
    # occupancy: if nothing lives beyond the window the prefix is compact
    table.high_water = torch.where(any_beyond, table.high_water, n_live).to(torch.int32)
    return table


def table_from_numpy(arrays: dict, device) -> VoxelBlockTable:
    """A table holding the given arrays (keys: the field names), such as a
    JAX ``VoxelBlockTable``'s. Only lanes 0-3 of ``slot_geo`` are kept (the
    JAX table pads its rows to 128 lanes), and ``slot_keys`` must mirror
    ``keys`` / ``slots``, else this raises ``ValueError``."""
    from bundlefusion_tpu_torch.utils import owned_tensor

    dtypes = {f.name: torch.int32 for f in fields(VoxelBlockTable)}
    dtypes.update(dict.fromkeys(("sdf", "weight", "color", "slot_geo"), torch.float32))
    arrays = dict(arrays, slot_geo=np.asarray(arrays["slot_geo"])[:, :SLOT_GEO_LANES])
    keys, slots = np.asarray(arrays["keys"]), np.asarray(arrays["slots"])
    occ = keys != EMPTY_KEY
    expect = np.full(np.asarray(arrays["slot_keys"]).shape, EMPTY_KEY, np.int64)
    expect[slots[occ]] = keys[occ]
    if not np.array_equal(expect, np.asarray(arrays["slot_keys"])):
        raise ValueError("slot_keys does not mirror keys / slots")
    return VoxelBlockTable(**{name: owned_tensor(arrays[name], dt, device)
                              for name, dt in dtypes.items()})


def garbage_collect(table: VoxelBlockTable, weight_thresh: float = 0.0) -> VoxelBlockTable:
    """Free blocks whose max voxel weight <= thresh (reference
    ``garbageCollectIdentifyKernel``). The per-block max runs in slot order;
    only the [num_blocks + 1] summary is gathered into key order."""
    maxw_by_slot = torch.amax(table.weight, dim=-1)
    live_by_slot = table.slot_keys != EMPTY_KEY
    empty_by_slot = live_by_slot & (maxw_by_slot <= weight_thresh)
    slot = torch.clamp(table.slots, 0, table.num_blocks).to(torch.int64)
    mask = (table.keys != EMPTY_KEY) & empty_by_slot[slot]
    return free_blocks(table, mask)


def starve(table: VoxelBlockTable, amount: float = 1.0) -> VoxelBlockTable:
    """Decay all voxel weights (reference ``starveVoxelsKernel``), in place."""
    w = torch.clamp(table.weight - amount, min=0.0)
    scale = torch.where(
        table.weight > 0, w / torch.clamp(table.weight, min=1e-12), 0.0
    )
    table.color.mul_(scale.repeat(1, 3))
    table.weight.copy_(w)
    return table


def num_occupied(table: VoxelBlockTable) -> torch.Tensor:
    return torch.sum((table.keys != EMPTY_KEY).to(torch.int32))


def check_invariants(table: VoxelBlockTable) -> dict:
    """Host-side structural validation (reference ``debugHash()``):
    sortedness, key and slot uniqueness, free-list accounting, the
    slot-major inverse map. Returns violation counts (all zero = healthy)."""
    keys = table.keys.cpu().numpy()
    slots = table.slots.cpu().numpy()
    occ = keys != EMPTY_KEY
    n_occ = int(occ.sum())
    errs = {}
    errs["unsorted"] = int((np.diff(keys.astype(np.int64)) < 0).sum())
    occupied_keys = keys[occ]
    errs["duplicate_keys"] = int(n_occ - len(np.unique(occupied_keys)))
    occupied_slots = slots[occ]
    errs["duplicate_slots"] = int(n_occ - len(np.unique(occupied_slots)))
    errs["bad_slot_range"] = int(
        ((occupied_slots < 0) | (occupied_slots >= table.num_blocks)).sum()
    )
    free_count = int(table.free_count)
    errs["accounting"] = int(free_count + n_occ != table.num_blocks)
    fl = table.free_list.cpu().numpy()[:free_count]
    errs["free_occupied_overlap"] = int(len(np.intersect1d(fl, occupied_slots)))
    errs["duplicate_free_slots"] = int(free_count - len(np.unique(fl)))
    slot_keys = table.slot_keys.cpu().numpy()
    expect = np.full_like(slot_keys, EMPTY_KEY)
    expect[occupied_slots] = occupied_keys
    errs["slot_keys_mismatch"] = int((slot_keys != expect).sum())
    errs["high_water"] = int(
        n_occ > 0 and int(table.high_water) < occupied_slots.max() + 1
    )
    return errs
