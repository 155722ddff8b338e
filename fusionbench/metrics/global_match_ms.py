"""global_match_ms (ms, program span): the boundary's global match of the
new keyframe against every earlier one (``match_and_filter`` with the
store's append: the engine's ``time_submap_global_match`` stage, a span
while tracing) over the window, host ms (its enqueue and any wait for the
card) per boundary that ran it."""

from fusionbench import program


def read(rec):
    s = program.spans(rec, "time_submap_global_match")
    return sum(program.span_ms(x) for x in s) / len(s) if s else None
