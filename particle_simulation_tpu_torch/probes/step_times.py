"""Poisson-step times at the main path for one checkout of this repository,
per scheduler, as ``chip_smoke.py`` phases 5 and 5b drive it: the seed
state, 1 warm step, then ``--steps`` timed steps, each timed on the host
clock from a synchronize to a synchronize, and its mobility phase (the
scheduler's, called through ``poisson_step``'s ``phase`` override) with
CUDA events around the call; each step's ms, their mean and median, and
the final population.  A phase that is not self-compacting leaves the
compaction to the step, outside the phase's time.

The main path: 1M electrons, capacity 2M, grid 256^3, T=100, the bundled
sine table; ``--capacity``, ``--grid``, ``--t`` and ``--bbox-subgrid``
change its sizes (the benchmark's row: ``--capacity 50000000 --grid 512
--bbox-subgrid 128``).  ``--profile`` runs the timed steps under
``torch.profiler`` and adds the device time of the engine's kernel a step;
a checkout whose engines count ``out_reuses`` also prints it beside the
launches.  Only entry points that every version of the port has are
called (``SimConfig``, ``cross_section``, ``state.setup_particles``,
``ops.step.poisson_step``, ``schedulers.get_mobility_phase``), so
``--tree`` may name another checkout (a ``git archive`` of an earlier
commit): its package is imported in place of this one and builds its own
kernels.  Run it as a file, so that ``--tree`` decides which package
loads:

    python particle_simulation_tpu_torch/probes/step_times.py \\
        [--tree DIR] [--steps 3] [--schedulers dynamic_old,dynamic] \\
        [--spawn-depth 2] [--rng-rounds 13] [--open] [--capacity N] \\
        [--grid G] [--t T] [--bbox-subgrid S] [--profile]

``--spawn-depth`` and ``--rng-rounds`` outside the engines' compiled set
(depth 1-4, rounds 13 and 20) run their open instantiations; ``--open``
runs those at any pair (each phase on buffers sized for the open grid,
through ``ops/kernels/engine.py``'s ``Phase``, in checkouts that have
it).

To compare two trees, run them in turns in one call (parent, change,
change, parent): one card, one power limit.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

MAIN = dict(init_n=1_000_000, capacity=2_000_000, poisson_timestep=100,
            grid_size=(256, 256, 256))
# scheduler -> (module, its engine's Phase)
COUNTED = {"dynamic": ("worklog", "worklog_phase"),
           "dynamic_old": ("push_mcc", "staged_phase")}
# the engines' phase kernels, by the name the profiler gives them
ENGINE_KERNELS = ("worklog_phase", "staged_phase")


def open_phase(scheduler: str):
    """The scheduler's engine phase through its open instantiation at any
    (depth, rounds): the buffers sized for the open grid."""
    module, name = COUNTED[scheduler]
    launch = getattr(importlib.import_module(
        f"particle_simulation_tpu_torch.ops.kernels.{module}"), name)
    engine = importlib.import_module(
        "particle_simulation_tpu_torch.ops.kernels.engine")

    def phase(state, step, table, cfg, t_steps):
        blocks = engine.open_blocks(launch.engine.name, cfg, state.device)
        return launch.run(state, launch.buffers(state, cfg, blocks), step,
                          table, cfg, t_steps)

    phase.self_compacting = True
    return phase


def engine_ms(prof, steps: int) -> float:
    """Device ms a step of the engines' phase kernels in a profile."""
    total = 0.0
    for evt in prof.key_averages():
        if any(k in evt.key for k in ENGINE_KERNELS):
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
    return total / 1e3 / steps


def run(tree: str, schedulers, steps: int, depth: int = 2, rounds: int = 13,
        force_open: bool = False, sizes: dict = MAIN,
        profile: bool = False) -> None:
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
        cfg = SimConfig(**sizes, scheduler=scheduler, spawn_depth=depth,
                        rng_rounds=rounds)
        fn = open_phase(scheduler) if force_open else get_mobility_phase(
            scheduler)
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
        counted = getattr(importlib.import_module(
            "particle_simulation_tpu_torch.ops.kernels."
            + COUNTED[scheduler][0]), COUNTED[scheduler][1])
        before = {k: getattr(counted, k, None)
                  for k in ("launches", "out_reuses")}
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity
            prof = torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        for s in range(1, steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = poisson_step(st, s, table, cfg, phase=phase)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        extra = ""
        if prof is not None:
            prof.stop()
            extra += f"; engine kernel device ms {engine_ms(prof, steps):.4f}"
        if before["out_reuses"] is not None:
            extra += (f"; out_reuses {counted.out_reuses - before['out_reuses']}"
                      f" of {counted.launches - before['launches']} launches")
        variant = (f" spawn_depth={depth} rng_rounds={rounds}"
                   + (" open" if force_open else "")
                   + f" capacity={cfg.capacity} grid={cfg.grid_size[0]}"
                   f" T={cfg.poisson_timestep}")
        print(f"{os.path.abspath(tree)} {scheduler}{variant}: steps "
              f"1-{steps} ms "
              f"{stats(ms)}; mobility phase ms {stats(phase_ms)}{extra}; "
              f"final n={st.n}", flush=True)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose package runs (default: this one)")
    ap.add_argument("--steps", type=int, default=3,
                    help="timed Poisson steps after the warm one")
    ap.add_argument("--schedulers", default="dynamic_old,dynamic",
                    help="comma-separated schedulers, each from the seed")
    ap.add_argument("--spawn-depth", type=int, default=2)
    ap.add_argument("--rng-rounds", type=int, default=13)
    ap.add_argument("--open", action="store_true",
                    help="the engines' open instantiations at any pair")
    ap.add_argument("--capacity", type=int, default=MAIN["capacity"])
    ap.add_argument("--grid", type=int, default=MAIN["grid_size"][0],
                    help="cells along each axis")
    ap.add_argument("--t", type=int, default=MAIN["poisson_timestep"],
                    help="mobility steps a Poisson step")
    ap.add_argument("--bbox-subgrid", type=int, default=None,
                    help="the field phase's subgrid (default: the port's)")
    ap.add_argument("--profile", action="store_true",
                    help="the engine kernel's device time, by profiler")
    args = ap.parse_args(argv)
    sizes = dict(MAIN, capacity=args.capacity, grid_size=(args.grid,) * 3,
                 poisson_timestep=args.t)
    if args.bbox_subgrid is not None:
        sizes["bbox_subgrid"] = args.bbox_subgrid
    run(args.tree, args.schedulers.split(","), args.steps, args.spawn_depth,
        args.rng_rounds, args.open, sizes, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
