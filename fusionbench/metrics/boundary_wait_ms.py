"""boundary_wait_ms (ms, program span): the host's wait for the card inside
a boundary's span (every read and drain goes through ``utils.host_wait``;
the span's ``wait_incl_ns``) over the window, mean per boundary."""

from fusionbench import program


def read(rec):
    return program.per_boundary(rec, lambda s: 1e-6 * s["wait_incl_ns"])
