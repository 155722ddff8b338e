"""``python -m fusionbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``."""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host side of the program is a Python
# loop, and idle pool threads spinning on the shared cores only slow it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

from fusionbench import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run.main(t_start=T_START))
