"""Entry point: ``python -m gpubench --workload ... --seed ... --seconds ...
--trace ...``."""

import time

T0 = time.perf_counter()  # before torch is imported: set-up starts here

import sys  # noqa: E402

from gpubench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
