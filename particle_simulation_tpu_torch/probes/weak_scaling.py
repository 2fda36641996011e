"""Weak scaling of the sharded path (counterpart of
``scripts/weak_scaling.py``): the same work on every rank, at 1, 2, 4, ...
ranks, through ``parallel.launch.run`` and ``parallel.sharded``.

The work of a rank is the main path's: 1M electrons, capacity 2M, the
256^3 grid, T=100, ``dynamic`` (the work-log kernel in every rank), the
replicated field (one int32 all-reduce of the charge grid a step).  For
each world size d a row gives:

* the ms of a Poisson step, mean and median of steps 1-3 (rank 0's host
  clock; the metrics' all-reduce ends a step, so the ranks move together);
* the final global n;
* each collective's calls, bytes and ms a step (``Mesh.stats``, over three
  more steps with the collectives timed between synchronises);
* the bytes a rank moves in a ring all-reduce of the charge grid,
  ``2 * S * (d - 1) / d`` for a grid of S bytes, the model the JAX script
  prices.  No interconnect estimate is printed: the rate that would price
  it is not measured here.

On the card each rank takes a card of its own over NCCL; the sweep stops
at the first world size the machine has no cards for, and says so.  On
the CPU (``--device cpu``) the ranks are gloo processes; ``--small`` runs
a configuration a CPU finishes in seconds.  Rows go to a CSV only when
``--csv PATH`` is given.

    python -m particle_simulation_tpu_torch.probes.weak_scaling \\
        [--max-ranks 4] [--device cpu] [--small] [--csv PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import List, Optional

import torch

from ..config import SimConfig
from ..cross_section import load_table
from ..device import resolve
from ..parallel import launch
from ..parallel.sharded import (
    Mesh, kernel_counters, setup_sharded, sharded_poisson_loop,
)

# the work of one rank: the main path (bench.py's headline)
PER_RANK = SimConfig(init_n=1_000_000, capacity=2_000_000, poisson_steps=4,
                     poisson_timestep=100, grid_size=(256, 256, 256),
                     scheduler="dynamic")
# a configuration gloo ranks on a CPU finish in seconds
SMALL = SimConfig(init_n=2_000, capacity=16_384, poisson_steps=4,
                  poisson_timestep=10, grid_size=(32, 32, 32),
                  scheduler="dynamic")
TIMED_STEPS = 3
CSV_HEADER = ("ranks,n_global_init,step_ms_mean,step_ms_median,final_n,"
              "charge_bytes_step,charge_ms_step,ring_allreduce_bytes")


def ring_allreduce_bytes(grid_bytes: int, ranks: int) -> float:
    """Bytes each rank sends in a ring all-reduce of ``grid_bytes``."""
    return 2.0 * grid_bytes * (ranks - 1) / ranks


def rank_run(mesh: Mesh, config: SimConfig) -> dict:
    """The rank function of ``launch.run``: ``config.poisson_steps`` steps
    for the step times, then ``TIMED_STEPS`` more with the collectives
    timed; this rank's numbers, with the kernels it launched."""
    kernels = kernel_counters()
    for k in kernels.values():
        k.launches = 0
    table = load_table(config.cross_section_path, mesh.device)
    state = setup_sharded(config, mesh)
    state, m = sharded_poisson_loop(state, table, config, mesh,
                                    config.poisson_steps)
    mesh.reset_stats()
    mesh.timed = True
    state, timed = sharded_poisson_loop(state, table, config, mesh,
                                        TIMED_STEPS,
                                        first_index=config.poisson_steps)
    mesh.timed = False
    return {
        "step_ms": [s * 1e3 for s in m["wall_s"]],
        "n": m["n"] + timed["n"],
        "comm": {k: [c / TIMED_STEPS, b / TIMED_STEPS, ms / TIMED_STEPS]
                 for k, (c, b, ms) in mesh.stats.items()},
        "launches": {name: k.launches for name, k in kernels.items()},
        "device": str(mesh.device),
        "backend": mesh.backend,
    }


def row_of(ranks: int, config: SimConfig, res: dict) -> dict:
    """A sweep row from rank 0's result."""
    later = res["step_ms"][1:4]
    g = config.grid_size
    charge = res["comm"].get("charge", [0, 0, 0.0])
    return {
        "ranks": ranks,
        "n_global_init": config.init_n * ranks,
        "step_ms_mean": statistics.fmean(later),
        "step_ms_median": statistics.median(later),
        "final_n": res["n"][-1],
        "charge_bytes_step": charge[1],
        "charge_ms_step": charge[2],
        "ring_allreduce_bytes": ring_allreduce_bytes(4 * g[0] * g[1] * g[2],
                                                     ranks),
        "comm": res["comm"],
        "launches": res["launches"],
        "backend": res["backend"],
    }


def format_row(row: dict) -> str:
    comm = "; ".join(f"{k} {c:g} calls {b:.0f} B {ms:.4f} ms"
                     for k, (c, b, ms) in sorted(row["comm"].items()))
    return (f"weak_scaling ranks={row['ranks']} ({row['backend']}): ms a "
            f"step mean {row['step_ms_mean']:.3f} median "
            f"{row['step_ms_median']:.3f} (steps 1-3); final n "
            f"{row['final_n']}; a step: {comm}; ring all-reduce model "
            f"{row['ring_allreduce_bytes']:.0f} B a rank")


def sweep(config: SimConfig = PER_RANK, max_ranks: int = 4, device=None,
          csv: Optional[str] = None, timeout_s: float = 600.0) -> List[dict]:
    """Rows at 1, 2, 4, ... ranks up to ``max_ranks``; on the card only as
    far as the cards go (the stop is printed)."""
    device = resolve(device)
    rows = []
    d = 1
    while d <= max_ranks:
        if device.type == "cuda" and d > torch.cuda.device_count():
            print(f"weak_scaling: stopped before {d} ranks: one card a rank "
                  f"over NCCL, {torch.cuda.device_count()} visible",
                  flush=True)
            break
        res = launch.run(rank_run, d, args=(config,), device=device,
                         timeout_s=timeout_s)
        row = row_of(d, config, res[0])
        print(format_row(row), flush=True)
        rows.append(row)
        d *= 2
    if csv:
        os.makedirs(os.path.dirname(csv) or ".", exist_ok=True)
        with open(csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for r in rows:
                f.write(",".join(str(r[k]) for k in CSV_HEADER.split(","))
                        + "\n")
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-ranks", type=int, default=4)
    ap.add_argument("--device", default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = sweep(SMALL if args.small else PER_RANK, args.max_ranks,
                 args.device, args.csv)
    print(json.dumps({"weak_scaling": [
        {k: v for k, v in r.items() if k not in ("comm", "launches")}
        for r in rows]}))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
