"""frame_step_dev_ms (ms, program span): the frame program (``_frame_step``
graphs: SIFT, matching, the filter cascade) between two waits for the
device, the engine's ``dev_frame_step`` in its replay, mean per frame."""


def read(rec):
    rep = rec["replay"] or {}
    return rep.get("device_ms", {}).get("dev_frame_step")
