"""local_gn_taken (steps, program counter): the local Gauss-Newton steps
whose update was applied, not masked by the early-out (``local_gn_taken``,
counted on the card over the window and read when tracing stops), per
boundary of the window."""

from fusionbench import program


def read(rec):
    taken = program.counters(rec).get("local_gn_taken")
    n = len(program.spans(rec, "boundary"))
    return taken / n if taken is not None and n else None
