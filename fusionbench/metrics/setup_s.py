"""setup_s (s, host clock): from the process's start to the first timed
frame: imports, the kernels' build, the scan's render, the engine, its
``warmup()`` (captures) and the untimed frames."""


def read(rec):
    return rec["setup_s"]
