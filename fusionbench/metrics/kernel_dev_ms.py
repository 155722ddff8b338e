"""kernel_dev_ms (ms, device trace): device time of the five hand kernels
(``kernels/*.cu``: TSDF prepare, cull and apply, the Kabsch and the
surface-area filters) per frame, from the profiler's device-only stretch of
the window."""


def read(rec):
    p = rec["profile"].get("device", {})
    if not p or not p.get("frames") or not p.get("hand_kernel_s"):
        return None
    return 1e3 * p["hand_kernel_s"] / p["frames"]
