"""The readings that a cell's correctness limits are set from: one run of
the cell with a short window, then for every sampled answer the port's
reading against the plain reference and the control's (the reference
computed in bfloat16, reference/compare.py) against the same reference,
as one JSON line:

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds 3

A limit lies above the largest reading of sound runs of the port over a
dozen seeds or more and below the smallest reading of the control. The
benchmark's own runs (run.py) never run the control.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import harness  # noqa: E402
import program  # noqa: E402
from reference.compare import worst  # noqa: E402


def readings(cell, seed, seconds, device="cuda"):
    """(the port's readings, the control's readings) of one short run."""
    loop = harness.driver_of(cell).Loop(cell, seed, harness.Spans(), device)
    loop.run(seconds, harness.Stretch(None, 0, 0, False))
    program.sync(device)
    loop.release()
    pairs = loop.answers(loop.reference())
    port = worst([loop.compare(g, w) for g, w in pairs])
    ctrl = loop.answers(loop.reference(control=True))
    control = worst([loop.compare(c, w)
                     for (_, c), (_, w) in zip(ctrl, pairs)])
    return port, control


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_chip(cell.entry["chips"])
    port, control = readings(cell, args.seed, args.seconds)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "port": port, "control": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
