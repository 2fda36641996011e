"""The row compaction and the lookup probe of one checkout of this
repository, checked against their plain twins and timed, so that two
versions of the kernels can be compared in one call on one card.

For the checkout named by ``--tree`` (default: this one), its package's
``ops.kernels.compact.row_compact`` and ``ops.kernels.lookup_bench.
lookup_bench`` run at the probes' main shapes, with the inputs of its own
``probes.experiment_worklog`` and ``probes.microbench_lookup``:

* ``row_compact`` at (16384, 128), equal to ``row_compact_plain``, then
  timed warm (one input, rerun) and cold (rotating through enough rolled
  copies of the input that inputs and outputs exceed twice the L2);
* ``lookup_bench`` in every variant that checkout has, each bitwise equal
  to ``lookup_bench_plain`` (``none`` to zeros), each timed warm.

The timing is this file's own ``common.py`` (loaded by path), whichever
tree runs, so both trees are timed alike.  Run it as a file, so that
``--tree`` decides which package loads; each tree builds its own kernels:

    python particle_simulation_tpu_torch/probes/probe_times.py [--tree DIR]

To compare two trees, run them in turns in one call (parent, change,
change, parent): one card, one power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _common():
    """This tree's probes/common.py, whichever package is imported."""
    spec = importlib.util.spec_from_file_location(
        "_probe_times_common", os.path.join(HERE, "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(tree: str, reps: int) -> str:
    common = _common()
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from particle_simulation_tpu_torch.ops.kernels import compact, lookup_bench
    from particle_simulation_tpu_torch.probes import (
        experiment_worklog, microbench_lookup,
    )

    if not torch.cuda.is_available():
        raise SystemExit("probe_times: the probe runs the card; no CUDA")
    dev = torch.device("cuda", 0)

    x = experiment_worklog.make_lanes(experiment_worklog.ROWS, seed=1,
                                      device=dev)
    out, ptr = compact.row_compact(x)
    want_out, want_ptr = compact.row_compact_plain(x)
    if int(ptr) != int(want_ptr) or not torch.equal(out, want_out):
        raise AssertionError(f"{tree}: row_compact differs from plain")
    n_bytes = 2 * x.numel() * 4
    sets = common.rotation_sets(n_bytes)
    rolled = [(x.roll(k * 997, 0),) for k in range(sets)]
    parts = [
        f"row_compact warm {common.time_ms(compact.row_compact, x, reps=reps):.4f}",
        f"cold {common.time_ms_cold(compact.row_compact, rolled):.4f} ms "
        f"({sets} sets)",
    ]
    del rolled

    inp = microbench_lookup.make_inputs(device=dev)
    want = lookup_bench.lookup_bench_plain(*inp, "global")
    for variant in lookup_bench.VARIANTS:
        got = lookup_bench.lookup_bench(*inp, variant)
        ref = torch.zeros_like(want) if variant == "none" else want
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"{tree}: lookup_bench {variant} differs")
        ms = common.time_ms(lookup_bench.lookup_bench, *inp, variant,
                            reps=reps)
        parts.append(f"lookup_bench {variant} {ms:.4f} ms")
    return f"{os.path.abspath(tree)}: " + "; ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose package runs (default: this one)")
    ap.add_argument("--reps", type=int, default=20,
                    help="calls a warm timing averages over")
    args = ap.parse_args(argv)
    print(run(args.tree, args.reps), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
