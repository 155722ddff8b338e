"""host_frame_ms (ms, host clock): the mean host time of a
``process_frame`` call (with its upload) on the window's frames that are not
a submap boundary: the entry point and host scheduler
(``pipeline/online.py``), the benchmark's own span around each call."""


def read(rec):
    ms = [1e3 * (e - s) for (s, e), b in zip(rec["spans"], rec["boundary"]) if not b]
    return sum(ms) / len(ms) if ms else None
