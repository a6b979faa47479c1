"""``python -m perfbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: the same as ``perfbench/run.py``."""

import sys

from perfbench.harness import main

sys.exit(main())
