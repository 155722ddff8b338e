"""device_idle_share (%, device trace): the share of the profiler's
device-only stretch of the window in which no operation ran on the device,
100 * (1 - busy / wall)."""


def read(rec):
    p = rec["profile"].get("device", {})
    if not p or not p.get("window_s") or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
