"""Poisson-step times at the main path for one checkout of this repository,
per scheduler, as ``chip_smoke.py`` phases 5 and 5b drive it: the seed
state, 1 warm step, then ``--steps`` timed steps, each timed on the host
clock from a synchronize to a synchronize, and its mobility phase (the
scheduler's, called through ``poisson_step``'s ``phase`` override) with
CUDA events around the call; each step's ms, their mean and median, and
the final population.  A phase that is not self-compacting leaves the
compaction to the step, outside the phase's time.

The main path: 1M electrons, capacity 2M, grid 256^3, T=100, the bundled
sine table.  Only entry points that every version of the port has are
called (``SimConfig``, ``cross_section``, ``state.setup_particles``,
``ops.step.poisson_step``, ``schedulers.get_mobility_phase``), so
``--tree`` may name another checkout (a ``git archive`` of an earlier
commit): its package is imported in place of this one and builds its own
kernels.  Run it as a file, so that ``--tree`` decides which package
loads:

    python particle_simulation_tpu_torch/probes/step_times.py \\
        [--tree DIR] [--steps 3] [--schedulers dynamic_old,dynamic]

To compare two trees, run them in turns in one call (parent, change,
change, parent): one card, one power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

MAIN = dict(init_n=1_000_000, capacity=2_000_000, poisson_timestep=100,
            grid_size=(256, 256, 256))


def run(tree: str, schedulers, steps: int) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from particle_simulation_tpu_torch import SimConfig, cross_section
    from particle_simulation_tpu_torch.ops.step import poisson_step
    from particle_simulation_tpu_torch.schedulers import get_mobility_phase
    from particle_simulation_tpu_torch.state import setup_particles

    if not torch.cuda.is_available():
        raise SystemExit("step_times: the probe runs the card; no CUDA")
    dev = torch.device("cuda", 0)
    table = cross_section.load_table(cross_section.bundled_paths()[0], dev)

    def stats(ms):
        return (", ".join(f"{x:.3f}" for x in ms)
                + f"; mean {sum(ms) / len(ms):.3f}, median "
                f"{sorted(ms)[len(ms) // 2]:.3f}")

    for scheduler in schedulers:
        cfg = SimConfig(**MAIN, scheduler=scheduler)
        fn = get_mobility_phase(scheduler)
        phase_ms = []

        def phase(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            torch.cuda.synchronize()
            phase_ms.append(start.elapsed_time(stop))
            return out

        phase.self_compacting = getattr(fn, "self_compacting", False)
        st = setup_particles(cfg, device=dev)
        st, _ = poisson_step(st, 0, table, cfg, phase=phase)
        ms = []
        del phase_ms[:]
        for s in range(1, steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = poisson_step(st, s, table, cfg, phase=phase)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"{os.path.abspath(tree)} {scheduler}: steps 1-{steps} ms "
              f"{stats(ms)}; mobility phase ms {stats(phase_ms)}; final "
              f"n={st.n}", flush=True)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose package runs (default: this one)")
    ap.add_argument("--steps", type=int, default=3,
                    help="timed Poisson steps after the warm one")
    ap.add_argument("--schedulers", default="dynamic_old,dynamic",
                    help="comma-separated schedulers, each from the seed")
    args = ap.parse_args(argv)
    run(args.tree, args.schedulers.split(","), args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
