"""Run one cell of the port's benchmark on the card and print its result
as one JSON line:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a window with the profiler off and a profiled
stretch after it.  Both check the window's work against the plain
reference and print each number compared beside its limit.  Without a
CUDA device, or without the port beside this folder, it exits nonzero and
prints no result.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], harness.process_start()))
