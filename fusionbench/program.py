"""Reading the program's span records and counters of a traced window.

``rec["program"]`` holds what ``System.program`` took once the window of a
``--trace 1`` run had closed: ``spans``, the engine's span records
(``eng.spans()``: name, frame, host start and end in ns, host wait while
innermost and over the subtree, counters own and over the subtree) from
just before the window's first frame to just after its last, and
``counters`` (``eng.counters()``: the TSDF rows and applied local
Gauss-Newton steps of that stretch, the map's staleness). The readers in
``metrics/`` take their numbers through these helpers; each returns None
where there is nothing to read.
"""

from __future__ import annotations


def spans(rec: dict, name: str) -> list:
    """The window's span records named ``name``; [] for a run without
    records."""
    return [s for s in (rec.get("program") or {}).get("spans", []) if s["name"] == name]


def counters(rec: dict) -> dict:
    return (rec.get("program") or {}).get("counters", {})


def span_ms(span: dict) -> float:
    return 1e-6 * (span["t1_ns"] - span["t0_ns"])


def ordinary_frames(rec: dict) -> set:
    """The window's frames that are not a submap boundary: those with a
    ``process_frame`` span and no ``boundary`` span."""
    return ({s["frame"] for s in spans(rec, "process_frame")}
            - {s["frame"] for s in spans(rec, "boundary")})


def ms_per_ordinary_frame(rec: dict, name: str):
    """Host ms of the spans ``name`` on the window's ordinary frames, summed
    and divided by the count of those frames."""
    frames = ordinary_frames(rec)
    picked = [s for s in spans(rec, name) if s["frame"] in frames]
    return sum(span_ms(s) for s in picked) / len(frames) if picked else None


def per_boundary(rec: dict, value):
    """The mean of ``value(span)`` over the window's ``boundary`` spans."""
    b = spans(rec, "boundary")
    return sum(value(s) for s in b) / len(b) if b else None
