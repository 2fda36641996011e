"""What the program's spans (``utils.profiling.span``) cost.

* Off: one span's enter and exit with no profiler recording, the mean
  over a million, in us, and that times the spans of one episode of the
  benchmark's row (``SPANS_AN_EPISODE``).
* On: one state's field phase (``ops.step.grid_phase``) and mobility step
  (``ops.step.mobility_step``), each timed on the host clock from a
  synchronise to a synchronise, inside one ``torch.profiler`` session,
  with the spans recording and with them off (the profiler's flag hidden
  from ``span``), in turns; the mean and median ms of each.

The state is the benchmark's ``sine512`` row (1M electrons, capacity
5e7, 512^3, ``bbox_subgrid`` 128, T=100) on the card; ``--small`` cuts it
to a size the CPU runs in seconds::

    python -m particle_simulation_tpu_torch.probes.span_cost \\
        [--scheduler dynamic] [--pairs 100] [--device cpu --small]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
import timeit
import types

import torch

from .. import SimConfig
from ..cross_section import load_table
from ..ops import step
from ..state import setup_particles
from ..utils import profiling

ROW = dict(init_n=1_000_000, capacity=50_000_000, grid_size=(512, 512, 512),
           bbox_subgrid=128, poisson_timestep=100)
SMALL = dict(init_n=300, capacity=20_000, grid_size=(32, 32, 32),
             bbox_subgrid=32, poisson_timestep=6)
# spans a run_pic episode of 10 Poisson steps opens: pst.run, pst.setup
# and 4 parts, and a step's pst.step, pst.sync, pst.field and 7 parts,
# pst.mobility and 3 parts
SPANS_AN_EPISODE = 2 + 4 + 10 * (2 + 8 + 4)
_OFF_FLAG = types.SimpleNamespace(_is_profiler_enabled=False)


def off_us(n: int = 1_000_000) -> float:
    """Mean us of one span's enter and exit with no profiler."""

    def one():
        with profiling.span("pst.probe"):
            pass

    return timeit.timeit(one, number=n) / n * 1e6


def on_ms(cfg: SimConfig, device, pairs: int) -> dict:
    """{"on"|"off": {"field"|"mobility": [ms, ...]}}: the field phase and
    the mobility step of one state under one profiler session, with the
    spans recording and off, in turns."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    table = load_table(cfg.cross_section_path, device)
    state = setup_particles(cfg, device=device)
    step.mobility_step(step.grid_phase(state, cfg), 0, table, cfg)  # warm
    times = {m: {"field": [], "mobility": []} for m in ("on", "off")}
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities):
        for i in range(2 * pairs):
            mode = ("on", "off")[(i + i // 2) % 2]  # on off off on ...
            if mode == "off":
                profiling._autograd_profiler = _OFF_FLAG
            try:
                sync()
                t0 = time.perf_counter()
                fielded = step.grid_phase(state, cfg)
                sync()
                t1 = time.perf_counter()
                step.mobility_step(fielded, 0, table, cfg)
                sync()
                t2 = time.perf_counter()
            finally:
                profiling._autograd_profiler = torch.autograd.profiler
            times[mode]["field"].append((t1 - t0) * 1e3)
            times[mode]["mobility"].append((t2 - t1) * 1e3)
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--scheduler", default="dynamic")
    p.add_argument("--pairs", type=int, default=100)
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    cfg = SimConfig(**(SMALL if args.small else ROW),
                    scheduler=args.scheduler)
    us = off_us(10_000 if args.small else 1_000_000)
    out = {"device": (torch.cuda.get_device_name(0)
                      if args.device.startswith("cuda") else args.device),
           "scheduler": args.scheduler, "off_us": us,
           "off_ms_an_episode": us * SPANS_AN_EPISODE * 1e-3}
    for mode, by in on_ms(cfg, args.device, args.pairs).items():
        for phase, ms in by.items():
            out[f"{phase}_ms_{mode}"] = {"mean": statistics.fmean(ms),
                                         "median": statistics.median(ms)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
