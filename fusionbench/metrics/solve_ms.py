"""solve_ms (ms, program span): the local plus global solve
(``solver/gn_pcg.py``, ``solver/dense_term.py``) per replayed boundary, the
engine's ``time_submap_local_solve`` and ``time_submap_global_solve`` on the
replay's boundaries (each starts after a drain of the device)."""


def read(rec):
    rep = rec["replay"] or {}
    n = rep.get("boundaries", 0)
    st = rep.get("stage_s", {})
    if not n or "time_submap_local_solve" not in st:
        return None
    s = st["time_submap_local_solve"] + st.get("time_submap_global_solve", 0.0)
    return 1e3 * s / n
