#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (theia_tpu_torch), one run of one
cell:

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Runs `python -m theia_tpu_torch.manager --device cuda` as a child
process, drives it over HTTP from this process, measures the cell's
end-to-end metrics (--trace 0) or its per-layer metrics from the
manager's counters and a device trace (--trace 1), holds what the timed
path produced against the plain references in portbench/reference/,
and prints one JSON object as the last line of standard output. The
numbers compared, each with its limit, are the last lines of standard
error and the last key of that object.

Exits non-zero, printing no result, without a CUDA card, when the run
fails, or when the process holds JAX or the JAX package at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    cell = harness.Cell(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    held = harness.forbidden_modules()
    if held:
        print(f"the benchmark's process holds {held}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
