"""Benchmark sweep (counterpart of ``particle_simulation_tpu/benchmarks.py``;
the reference's runBenchmark, src/test.cu:4-41).

Canonical sweep: mobility steps 10,20,..,100,200,..,1000 x schedulers, with
init_n=1e6, capacity=5e7, 10 Poisson steps; the output CSV has the
reference's schema, so its analyse/ scripts apply unchanged.  Block size
has no meaning for the engines, so the sweep's other dimension is the
scheduler.  Profiles ``quick`` and ``ci`` cut the sweep to size.

Timing protocol: each scheduler's first row is preceded by a warm run (the
kernels' build and the allocator's first allocations are never timed), and
rows are appended to the CSV as they complete, so an interrupted sweep
still leaves a valid artifact.

The default CSV is the port's own file: the JAX package's default,
``out/data/mobility_timesteps_nodet.csv``, holds the TPU's sweep.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from . import cross_section
from .config import SimConfig
from .observability import CSV_HEADER, csv_row
from .runtime import FUNCTION_NAMES, RunData, run_pic

DEFAULT_CSV = "out/data/mobility_timesteps_nodet_torch.csv"


def sweep_configs(profile: str = "full") -> List[SimConfig]:
    if profile == "ci":
        mobility = [4, 8]
        init_n, capacity, poisson_steps = 200, 4000, 2
        grid = (16, 16, 16)
        schedulers = ["naive", "sync"]
    elif profile == "quick":
        mobility = [10, 50, 100]
        init_n, capacity, poisson_steps = 100_000, 2_000_000, 3
        grid = (128, 128, 128)
        schedulers = ["naive", "dynamic"]
    else:
        mobility = list(range(10, 100, 10)) + list(range(100, 1001, 100))
        init_n, capacity, poisson_steps = 1_000_000, 50_000_000, 10
        grid = (512, 512, 512)
        # fastest engines first, so a time-budget truncation still leaves
        # the headline comparison (Dynamic flat vs Naive linear) complete
        schedulers = ["dynamic", "naive", "dynamic_old", "sync"]

    return [
        SimConfig(
            init_n=init_n,
            capacity=capacity,
            poisson_steps=poisson_steps,
            poisson_timestep=mob,
            scheduler=sched,
            grid_size=grid,
            # the canonical artifact's draw protocol (the JAX package's
            # recorded rows pin it), so final n compares across packages
            rng_mode="perstep",
            rng_rounds=13,
            # the JAX package's engine-build provenance; ignored here
            worklog_unroll=1,
            lookup_mode="staticthresh",
            lookup_hits=False,
        )
        for sched in schedulers  # scheduler-major: one warm run each
        for mob in mobility
    ]


def _append_csv(path: str, run: RunData) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(CSV_HEADER + "\n")
        f.write(csv_row(run) + "\n")


def _recorded_rows(out_csv: str):
    """(func, mobility steps) -> [time_ms, ...] for rows already in the CSV
    (a list per key: repeat_map rows appear several times, and a resumed
    sweep must know how many reps landed)."""
    done = {}
    if os.path.exists(out_csv):
        with open(out_csv) as f:
            for line in f.readlines()[1:]:
                parts = line.strip().split(",")
                if len(parts) >= 9:
                    done.setdefault(
                        (parts[0], int(parts[3])), []
                    ).append(float(parts[8]))
    return done


def run_benchmark(
    profile: str = "full",
    out_csv: str = DEFAULT_CSV,
    time_budget_s: Optional[float] = None,
    resume: bool = False,
    only_schedulers: Optional[List[str]] = None,
    repeat_map: Optional[dict] = None,
    max_t: Optional[dict] = None,
    device=None,
) -> List[RunData]:
    """Run the sweep on ``device`` (the card when None), appending each row
    to ``out_csv`` as it completes.

    ``resume=True`` keeps an existing CSV and skips configs already
    recorded; otherwise an existing CSV is moved to ``.bak`` and the sweep
    starts fresh.

    ``repeat_map`` maps (scheduler, T) -> total measurement count; extra
    measurements append duplicate rows, which is how the reference feeds
    seaborn's error bands (analyse/plot.py:36).  ``max_t`` maps scheduler
    -> highest T to record.

    Outlier protection: a measurement more than 5x above every
    same-scheduler time already recorded (and over 30 s) is measured once
    more and the retry recorded.
    """
    done = {}
    if resume:
        done = _recorded_rows(out_csv)
    elif os.path.exists(out_csv):
        os.rename(out_csv, out_csv + ".bak")
    configs = sweep_configs(profile)
    table = cross_section.load_table(configs[0].cross_section_path, device)
    runs: List[RunData] = []
    t_start = time.perf_counter()
    warmed = set()
    for cfg in configs:
        if only_schedulers and cfg.scheduler not in only_schedulers:
            continue
        if max_t and cfg.poisson_timestep > max_t.get(cfg.scheduler, 10**9):
            continue
        func = FUNCTION_NAMES[cfg.scheduler]
        reps_want = (repeat_map or {}).get(
            (cfg.scheduler, cfg.poisson_timestep), 1
        )
        reps_have = len(done.get((func, cfg.poisson_timestep), ()))
        if reps_have >= reps_want:
            continue
        if time_budget_s and time.perf_counter() - t_start > time_budget_s:
            print(f"time budget {time_budget_s}s reached — sweep truncated")
            break
        if cfg.scheduler not in warmed:
            # at T=10 whatever the row's T: a resumed sweep's first row may
            # be a long one, and the warm run only has to build and allocate
            run_pic(cfg.replace(poisson_timestep=10), table,
                    print_header=False, device=device)
            warmed.add(cfg.scheduler)
        prior = [t for (f, _), ts in done.items() if f == func for t in ts]
        prior += [r.device_time_ms for r in runs
                  if r.config.scheduler == cfg.scheduler]
        for rep in range(reps_have, reps_want):
            for attempt in range(2):
                t0 = time.perf_counter()
                run = run_pic(cfg, table, print_header=False, device=device)
                wall = time.perf_counter() - t0
                run.state = None  # 2.4 GB of device memory at capacity 5e7
                suspicious = (
                    prior
                    and run.device_time_ms > 5 * max(prior)
                    and run.device_time_ms > 30_000
                )
                if not suspicious or attempt == 1:
                    break
                print(
                    f"outlier {run.device_time_ms:.0f} ms (prior max "
                    f"{max(prior):.0f} ms) — re-measuring once",
                    flush=True,
                )
            if run.final_n >= cfg.capacity:
                print("Illegal configuration, capacity reached — skipping record")
                break
            pushes = estimate_pushes(run)
            print(
                f"{cfg.scheduler:12s} T={cfg.poisson_timestep:5d} "
                f"rep={rep} final_n={run.final_n:9d} "
                f"device={run.device_time_ms:9.1f} ms wall={wall:6.1f} s "
                f"pushes/s={pushes / max(run.device_time_ms / 1e3, 1e-9):.3e}",
                flush=True,
            )
            runs.append(run)
            _append_csv(out_csv, run)
    return runs


def estimate_pushes(run: RunData) -> float:
    """Total particle pushes executed — exact, counted by the engines
    (StepMetrics.pushes)."""
    return float(sum(m.pushes for m in run.steps))
