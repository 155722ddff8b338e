"""gn_steps (steps, program counter): Gauss-Newton steps of the local and
global solves (``gn_steps`` over a boundary span's subtree; the local
solve's counted as enqueued) over the window, mean per boundary."""

from fusionbench import program


def read(rec):
    return program.per_boundary(rec, lambda s: s["counters_incl"].get("gn_steps", 0))
