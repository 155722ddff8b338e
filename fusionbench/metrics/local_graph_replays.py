"""local_graph_replays (replays, program counter): the local solves that
replayed their CUDA graph (``local_graph_replays`` in
``time_submap_local_solve``) over the window, per boundary: 1 where every
local solve replays, 0 where each runs eagerly."""

from fusionbench import program


def read(rec):
    return program.per_boundary(rec, lambda s: s["counters_incl"].get("local_graph_replays", 0))
