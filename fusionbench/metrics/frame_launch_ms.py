"""frame_launch_ms (ms, program span): the host time of the CUDA graph
replays (``graph_launch`` spans: the frame program and the fusion programs)
on the window's ordinary frames, per such frame; None where nothing
replays (the CPU runs eagerly)."""

from fusionbench import program


def read(rec):
    return program.ms_per_ordinary_frame(rec, "graph_launch")
