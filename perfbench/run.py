"""Run one benchmark cell once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, a JSON object; the compared numbers and their limits are the last
lines of standard error. See ``perfbench/harness.py``.
"""
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    root = Path(__file__).resolve().parent.parent
    here = str(Path(__file__).resolve().parent)
    # import the package as ``perfbench.*`` from the checkout's root, never its
    # files as top-level modules
    sys.path[:] = [str(root)] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    from perfbench import harness

    harness.set_cache_dirs(root)
    sys.exit(harness.main())
