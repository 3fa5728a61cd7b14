"""``python -m perfbench``: see :mod:`perfbench.runner`."""

import time

T_START = time.perf_counter()  # set-up counts from here, before torch is imported

import sys  # noqa: E402

if __name__ == "__main__":
    from perfbench import runner

    sys.exit(runner.main(t_start=T_START))
