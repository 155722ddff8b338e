"""frame_ms_p95 (ms, host clock): the 95th percentile, over every frame of
the open-loop window, of the time from when the frame was due on the
sensor's schedule to when the device completed its pose, fusion and
render."""


def read(rec):
    return rec["window"].get("frame_ms_p95")
