"""Entry point: ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (or ``python3 -m perfbench.run ...``) from
the root of a checkout; see ``perfbench/harness.py``."""

import os
import sys

if __name__ == "__main__":
    # the checkout's root in place of this directory, whose module names
    # would shadow the standard library's
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench.harness import main

    sys.exit(main())
