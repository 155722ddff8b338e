"""frame_sched_ms (ms, program span): the host's re-integration scheduler
(``reint_schedule`` spans: ``_build_reintegrate_rows``, row packing,
marking) on the window's ordinary frames, per such frame."""

from fusionbench import program


def read(rec):
    return program.ms_per_ordinary_frame(rec, "reint_schedule")
