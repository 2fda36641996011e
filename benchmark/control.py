"""The readings that the limits of ``judge.LIMITS`` are set from, at a
cell's own size on the card (the benchmark's runs do not run this):

* the control: the plain reference computed in bfloat16, the precision
  below the configuration's float32, put in the program's place;
* with ``--faults``, each fault of ``faults.FAULTS`` planted in the
  program.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 1] [--faults]

Each reading is one line of JSON on standard output: the cell, the seed,
what ran in the program's place, ``correct`` and the numbers compared.
The program's own readings are the benchmark runs' ``compared`` numbers.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import faults  # noqa: E402
import harness  # noqa: E402


def reading(cell, seed, seconds, what, program):
    r = harness.run_cell(cell, seed, seconds, False, "cuda",
                         time.perf_counter(), program=program,
                         log=sys.stderr)
    print(json.dumps({"cell": cell.name, "seed": seed, "what": what,
                      "correct": r["correct"], "attempted": r["attempted"],
                      "compared": {k: v["value"]
                                   for k, v in r["compared"].items()}}),
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    for seed in args.seeds:
        reading(cell, seed, args.seconds, "control_bf16",
                harness.ReferenceProgram(cell, torch.bfloat16))
        if args.faults:
            for name, fault in faults.FAULTS.items():
                with fault():
                    reading(cell, seed, args.seconds, f"fault_{name}",
                            harness.PortProgram("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
