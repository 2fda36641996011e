"""The benchmark of particle_simulation_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port.  The last line of standard output is the result, one JSON
object; the numbers compared with the plain reference, each with its
limit, are the last lines of standard error.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled window.  A run needs as many CUDA cards as the cell names, and
refuses to print a result if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# kernel caches of any kind at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".benchcache", _sub))
sys.path.insert(1, ROOT)

import json  # noqa: E402

import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    import torch

    import particle_simulation_tpu_torch  # noqa: F401  the system under test

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
