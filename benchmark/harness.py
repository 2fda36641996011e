"""One run of one cell: set-up, the measured window of episodes, the
comparison with the plain reference, and the metrics.

Everything that belongs to one cell is found by name: the configuration
is the file that ``BENCHMARK.json`` names for it, the traffic mix is
``traffic/<traffic>.json`` and each metric is read by
``metrics/<metric>.py``'s ``read(readings)``, which returns a number or
None when the run has nothing for it to read.  A configuration's file
holds ``SimConfig`` fields, which go to the program, and the harness's
own keys: ``table`` (a file under this folder) and ``reference`` (the
module of its plain reference).  A traffic file holds ``SimConfig``
fields and the harness's ``episode_seeds`` (1 when it is left out).

An episode is one ``runtime.run_pic`` of the configuration from one of
``episode_seeds`` simulation seeds that the run draws from its seed; the
episodes take them in turn.  Every cycle of episodes repeats the same
work, so the window's work does not depend on the program's speed, and a
run's work is the mean of several populations, not one.  An episode fails
when it raises, overflows or hits 0.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import judge

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "particle_simulation_tpu")
HARNESS_KEYS = ("table", "reference", "source", "assumed", "notes",
                "guarantees", "episode_seeds")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench``, with its configuration and traffic
    read from their files and the metrics it reports."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} (one of {sorted(work)})")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in moved]
    return Cell(name, w["config"], config, w["traffic"], traffic,
                int(w["chips"]), e2e, layer)


def _load(module_name: str, path: str):
    """The module in the file ``path``, registered as ``module_name``."""
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return _load(f"bench_metric_{name}",
                 os.path.join(bench_dir, "metrics", name + ".py")).read


def reference_module(cell: Cell, bench_dir: str = BENCH_DIR):
    """The configuration's plain reference, ``<reference>.py``."""
    name = cell.config["reference"]
    return _load(f"bench_ref_{name}", os.path.join(bench_dir, name + ".py"))


def load_table(cell: Cell, device) -> torch.Tensor:
    """The configuration's (10000, 2) float32 chance table, from this
    folder's frozen copy: the one tensor both sides are given."""
    path = os.path.join(BENCH_DIR, cell.config["table"])
    data = np.loadtxt(path, dtype=np.float64).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(data)).to(device)


def episode_seeds(cell: Cell, seed: int) -> List[int]:
    """The run's simulation seeds: ``episode_seeds`` distinct 32-bit
    words drawn from ``seed`` (the program keys its draws with the low 32
    bits of a seed)."""
    rng, out = random.Random(f"episode seeds {seed}"), []
    while len(out) < int(cell.traffic.get("episode_seeds", 1)):
        word = rng.getrandbits(32)
        if word not in out:
            out.append(word)
    return out


def run_keys(cell: Cell) -> dict:
    """The configuration's and the traffic's keys, without the harness's."""
    keys = {k: v for k, v in {**cell.config, **cell.traffic}.items()
            if k not in HARNESS_KEYS}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in keys.items()}


# (n, added, removed, overflow, pushes) of each Poisson step
Counters = List[Tuple[int, int, int, bool, int]]


class PortProgram:
    """The system under test: ``particle_simulation_tpu_torch``'s
    ``runtime.run_pic`` (and, traced, the two calls of its Poisson step),
    with the program counters the per-layer metrics read."""

    def __init__(self, device):
        from particle_simulation_tpu_torch import SimConfig, runtime
        from particle_simulation_tpu_torch.config import check_supported
        from particle_simulation_tpu_torch.ops import grid, step
        from particle_simulation_tpu_torch.ops.kernels import push_mcc
        from particle_simulation_tpu_torch.ops.kernels import worklog
        from particle_simulation_tpu_torch.state import setup_particles

        self.device = torch.device(device)
        self._config = SimConfig
        self._run_pic = runtime.run_pic
        self._check = check_supported
        self._step = step
        self._setup = setup_particles
        self._field_counts = grid.field_counts
        self._engines = {"worklog": worklog.worklog_phase,
                         "staged": push_mcc.staged_phase}

    def config(self, keys: dict, seed: int):
        return self._config(**keys, seed=seed)

    def load_kernels(self) -> Optional[float]:
        """Builds (in the first run of a checkout) and loads the kernel
        library; the seconds it took, or None off the card."""
        if self.device.type != "cuda":
            return None
        from particle_simulation_tpu_torch.ops.kernels import build

        t0 = time.perf_counter()
        build.load()
        return time.perf_counter() - t0

    def counters(self) -> dict:
        """The program's own cumulative counters: the field phase's paths
        and readbacks, each engine's launches, passes and reclaims."""
        out = {f"field.{k}": v
               for k, v in self._field_counts.as_dict().items()}
        for name, fn in self._engines.items():
            for key in ("launches", "passes", "reclaims"):
                if hasattr(fn, key):
                    out[f"{name}.{key}"] = getattr(fn, key)
        return out

    def episode(self, sim, table) -> Tuple[Counters, torch.Tensor]:
        run = self._run_pic(sim, table=table, print_header=False,
                            device=table.device)
        counters = [(s.n, s.added, s.removed, bool(s.overflow), s.pushes)
                    for s in run.steps]
        return counters, judge.rows_of_state(run.state)

    def traced_episode(self, sim, table, spans: Dict[str, List[float]]
                       ) -> Tuple[Counters, torch.Tensor]:
        """The episode through ``ops.step.grid_phase`` and
        ``ops.step.mobility_step``, each between two synchronisations,
        with its host-clock span and a ``bench.*`` annotation."""
        from torch.profiler import record_function

        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        with record_function("bench.setup_particles"):
            state = self._setup(sim, device=self.device)
        counters: Counters = []
        for t in range(sim.poisson_steps):
            sync()
            t0 = time.perf_counter()
            with record_function("bench.field"):
                self._check(sim)
                state = self._step.grid_phase(state, sim)
                sync()
            t1 = time.perf_counter()
            with record_function("bench.mobility"):
                state, m = self._step.mobility_step(state, t, table, sim)
                sync()
            t2 = time.perf_counter()
            spans["field"].append(t1 - t0)
            spans["mobility"].append(t2 - t1)
            counters.append((m["n"], m["added"], m["removed"],
                             bool(m["overflow"]),
                             m["pushes_lo"] + (m["pushes_hi"] << 30)))
            if m["n"] == 0:
                break
        return counters, judge.rows_of_state(state)


class ReferenceProgram:
    """The plain reference in the program's place (the control): the
    configuration's reference computed in ``dtype``."""

    def __init__(self, cell: Cell, dtype):
        self.ref = reference_module(cell)
        self.cfg = {**cell.config, **cell.traffic}
        self.dtype = dtype

    def config(self, keys: dict, seed: int):
        return seed

    def load_kernels(self) -> Optional[float]:
        return None

    def counters(self) -> dict:
        return {}

    def episode(self, seed, table):
        ep = self.ref.episode(self.cfg, seed, table, self.dtype)
        return ep.counters, ep.rows


@dataclasses.dataclass
class Readings:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float
    window_s: float
    episode_s: List[float]
    pushes: int
    # per Poisson step of the window's episodes: (pushes, rows in, rows out)
    phases: List[Tuple[int, int, int]]
    counters: Dict[str, int]        # the program's counters over the window
    spans: Dict[str, List[float]]   # host-clock spans (traced runs)
    trace: Optional[object] = None  # devtrace.Trace (traced runs on the card)


def _phases(counters: Counters, init_n: int) -> List[Tuple[int, int, int]]:
    out, n_in = [], init_n
    for n, _, _, _, pushes in counters:
        out.append((pushes, n_in, n))
        n_in = n
    return out


def _failed(counters: Counters) -> bool:
    return not counters or any(c[3] for c in counters) or counters[-1][0] == 0


def card_state() -> Optional[dict]:
    """The card's clocks, power and temperature from ``nvidia-smi``."""
    fields = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return {"fields": fields, "cards": out}


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not
    load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, program=None, log=sys.stdout) -> dict:
    """One run: set-up and a warm episode of each simulation seed,
    ``seconds`` of episodes, the comparison, the metrics.  Returns the result line's object, with
    ``compared`` (each number and its limit) last."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    program = program or PortProgram(device)
    kernels_s = program.load_kernels()
    table = load_table(cell, device)
    seeds = episode_seeds(cell, seed)
    sims = [program.config(run_keys(cell), s) for s in seeds]
    init_n = int(cell.config["init_n"])
    spans: Dict[str, List[float]] = {"field": [], "mobility": []}

    def one(sim, record: bool):
        if traced:
            return program.traced_episode(sim, table, spans if record
                                          else {"field": [], "mobility": []})
        return program.episode(sim, table)

    for sim in sims:  # warm: every shape and population the window runs
        judge.fingerprint(one(sim, record=False)[1])
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    card_before = card_state() if cuda else None
    before = program.counters()

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        window_mark = record_function("bench.window")
        window_mark.__enter__()

    rng = random.Random(seed)
    all_counters: List[Counters] = []
    prints: List[torch.Tensor] = []
    episode_s: List[float] = []
    sample = None
    failed = attempted = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        attempted += 1
        e0 = time.perf_counter()
        try:
            counters, rows = one(sims[(attempted - 1) % len(sims)],
                                 record=True)
        except Exception:  # an episode that raises fails; stop the window
            traceback.print_exc()
            failed += 1
            break
        episode_s.append(time.perf_counter() - e0)
        all_counters.append(counters)
        prints.append(judge.fingerprint(rows))
        failed += _failed(counters)
        # one episode drawn from the seed, uniformly over the window's
        if rng.random() * len(all_counters) < 1.0:
            sample = (len(all_counters) - 1, rows.clone())
        del rows
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0

    trace = None
    if prof is not None:
        window_mark.__exit__(None, None, None)
        prof.stop()
        if cuda:
            trace = _read_trace(prof)
    after = program.counters()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    card_after = card_state() if cuda else None

    # the reference for each simulation seed, once the window has closed
    # and the program's state is gone
    if cuda:
        torch.cuda.empty_cache()
    refs = [reference_module(cell).episode(
        {**cell.config, **cell.traffic}, s, table) for s in seeds]
    numbers = judge.compare(all_counters, prints, failed, sample, refs)
    correct = judge.verdict(numbers)

    pushes = sum(c[4] for ep in all_counters for c in ep)
    phases = [p for ep in all_counters for p in _phases(ep, init_n)]
    readings = Readings(
        cell=cell, setup_s=setup_s, window_s=window_s, episode_s=episode_s,
        pushes=pushes, phases=phases,
        counters={k: after[k] - before.get(k, 0) for k in after},
        spans=spans, trace=trace)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    steps = max(len(phases), 1)
    print(json.dumps({"counters": {
        "episodes": attempted, "steps": len(phases),
        "episode_seeds": seeds, "kernels_load_s": kernels_s,
        "per_step": {k: v / steps for k, v in readings.counters.items()},
        "episode_ms_median": (statistics.median(episode_s) * 1e3
                              if episode_s else None),
        "memory_peak_bytes": peak}}), file=log)
    if cuda:
        print(json.dumps({"card": {"before": card_before,
                                   "after": card_after}}), file=log)

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.top_idle()}
    result["compared"] = {k: {"value": v, "limit": judge.LIMITS[k]}
                          for k, v in numbers.items()}
    return result


def _read_trace(prof):
    """The profiler's trace through its Chrome export (a temporary file
    under TMPDIR, removed once read)."""
    import devtrace

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return devtrace.read(path)
    finally:
        os.remove(path)

