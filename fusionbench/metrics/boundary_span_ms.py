"""boundary_span_ms (ms, program span): the host time of a submap
boundary's ``boundary`` span (``time_submap_step`` and that frame's
retirement of its pack) over the window, mean per boundary."""

from fusionbench import program


def read(rec):
    return program.per_boundary(rec, program.span_ms)
