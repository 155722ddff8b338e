"""tsdf_rows (rows, program counter): the map rows the culled TSDF sweeps
listed over the window (``tsdf_rows``, counted on the card and read when
tracing stops), per frame; None where no culled sweep ran (the CPU's full
sweep counts none)."""

from fusionbench import program


def read(rec):
    c = program.counters(rec)
    rows, frames = c.get("tsdf_rows"), c.get("frames")
    return rows / frames if rows and frames else None
