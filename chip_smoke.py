#!/usr/bin/env python3
"""Chip check of the PyTorch + CUDA port (particle_simulation_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, each printing one line or a few:

1. require CUDA (there is no CPU path);
2. the card's name and power limit (nvidia-smi);
3. build the kernels (csrc/worklog.cu, staged.cu, field.cu, compact.cu,
   sublane_gather.cu and lookup_bench.cu, one nvcc process each, in
   parallel) and print the build time;
4. each kernel against its plain PyTorch version on the same inputs, each
   Poisson step: the sorted particle multiset with ids and the counters
   n, added, removed, overflow, pushes_lo, pushes_hi must be equal
   (tolerance: exact);
   (a) work-log (worklog_phase, one launch a phase): const 50/50 table,
       65,536 particles, grid 64^3, T=20, 3 steps, spawn_depth 2 and 1 (1
       forces suspension);
   (b) work-log: the main path's configuration, its first 4 steps;
   (c) staged (staged_phase, one launch a phase; scheduler dynamic_old):
       the configuration of (a), through ops.step.poisson_step; the output
       tensors must also be equal bit for bit;
   (d) staged: the main path's configuration with dynamic_old, its first 4
       steps, against the work-log kernel every step (the cadence
       invariant) and against its plain version on steps 0 and 1; the
       phase's time at each step, its launches, passes and reclaims;
   (e) field gather: banded_gather against its plain twin on the probe's
       sorted and random ids; then the main path's field phase on its
       steps 0-2 (step 0 must take the bbox subgrid), the kernel path
       against the plain path (the same state on the CPU) and against the
       full grid (bbox_subgrid=0), and packed_field_gather against its
       plain twin on each step's gather inputs (all bitwise);
   (f) each fallback of the field phase forced once: the window (the
       const churn's 62-cell cube at bbox_subgrid=16) and the 10-bit
       packing (600 charges in one cell), against the full grid and the
       CPU (bitwise);
5. the main path: 1M electrons, capacity 2M, grid 256^3, T=100, the
   bundled sine table, scheduler dynamic, through ops.step.poisson_loop;
   1 warm and 3 timed Poisson steps (mean and median of the CUDA-event
   time of each), with the work-log launches, the passes the kernel
   counted and both per phase; then 3 more mobility phases, each run
   twice on the same input: once on the host clock, once under
   torch.profiler for the device's busy share of that run, the kernels it
   launched and its device-to-host copies (the readbacks; profile_phases
   says how); then the plain version over 1 warm and 3 timed steps;
   (b) the same with scheduler dynamic_old (the staged kernel: launches,
   device-counted passes and reclaims per phase, and 3 profiled phases),
   then its plain version over 1 warm and 1 timed step.  Each prints the
   field paths its steps took and the field phase's ms on its final state,
   the subgrid and the full-grid path alternated;
6. the field-gather probe (probes/microbench_fieldgather.py): its timing
   lines;
7. the three probes whose entry points are the port's remaining kernels,
   each at its script's sizes (probes/experiment_worklog.py,
   experiment_sublane_gather.py, microbench_lookup.py): each kernel against
   its plain twin, bitwise (row_compact at both sizes, then at 33 rows and
   at 777 empty rows, back to back on one cached look-back state;
   sublane_gather in both variants; lookup_bench in all five, banked the
   design); then, with the launch counts at 0, the probe's timings, which
   are its path: the kernel, its twin and the PyTorch call where one
   exists (row_compact warm and cold, its time against the bound the cold
   one; lookup_bench by variant, its time banked's);
8. the entry points as a user calls them, each with the launch counts at
   0 before it and read after it (every kernel it reaches must launch):
   (a) ``cli.main`` in mode ``test`` at the main path's 1M electrons, grid
       256^3, T=100, 2 Poisson steps, at a capacity where ``naive`` (which
       keeps the step's dead rows) does not overflow: four "success"
       lines, and ``dynamic`` equal to ``dynamic_old`` (multiset with ids,
       per-step counters);
   (b) ``python -m particle_simulation_tpu_torch`` modes 30 and 33 as
       subprocesses with npz checkpoints: the PNGs and checkpoints at the
       expected steps, every PNG decoded, ``checkpoint.resume_run`` from
       step 2 equal to the uninterrupted run, mode 33 equal to mode 30;
   (c) ``benchmarks.run_benchmark("full")`` for ``dynamic`` (T 10-1000)
       and ``dynamic_old`` (T <= 100) into a temporary CSV: the
       reference's header, each row's final n within 0.1% of the TPU's
       (out/data/mobility_timesteps_nodet.csv) up to T=100 and within 1%
       from T=200 (the TPU's float32 arithmetic is not the H100's, so the
       runs are alike in their statistics, not bit for bit), and the two
       engines equal at every shared T (final n, per-step counters, a
       digest of the final multiset with ids).  Per row: the ms per
       Poisson step, pushes/s, the field paths and the peak memory.
   The tracked CSVs must be byte-identical afterwards.

Any failed check raises, so the script exits non-zero.  The last line is
the device record {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on their path, their times, the plain
version's and the library call's, and the bound: the least time the H100
could take for the same work, from the bytes each input and output must
move once (3.35 TB/s) and the operations these inputs need (67 TFLOP/s
float32), whichever is larger (probes/common.py).
"""

from __future__ import annotations

import json
import os
import sys
import time

# operations a lane-step of the engines does (csrc/physics.cuh and
# threefry.cuh, counted with an FMA as two and logf as one; the 13-round
# Threefry block is shared by two steps under block2): the bound's count
OPS_PER_PUSH = 70
RECORD_BYTES = 48    # a particle: pos, vel, acc (3 x 12) + status, id_hi, id_lo
FIELD_OPS = 10       # a particle of the field gather: unpack, scale, mask
MAIN = dict(init_n=1_000_000, capacity=2_000_000, poisson_timestep=100,
            grid_size=(256, 256, 256), scheduler="dynamic")
# (a): the 50/50 table makes every draw split or absorb, so a step of T=20
# appends about 10x the live population (the BASELINE.md config-4 churn)
CHURN = dict(init_n=65_536, capacity=262_144, poisson_timestep=20,
             grid_size=(64, 64, 64), scheduler="dynamic")
# 8: the entry points.  (a) at capacity 4M: the naive cadence keeps the
# step's dead rows and overflows 2M at the main path's step 1
TEST_ARGV = ["test", "0", "1000000", "2", "256", "4000000", "0", "100",
             "grid=256"]
CLI_ARGV = ["30", "1", "1000000", "3", "256", "2000000", "0", "100",
            "grid=256"]
SWEEP = dict(profile="full", only_schedulers=["dynamic", "dynamic_old"],
             max_t={"dynamic_old": 100})
TPU_CSV = "out/data/mobility_timesteps_nodet.csv"
TRACKED_CSVS = (TPU_CSV, "out/data/quick_sweep_tpu.csv")
# relative bound on final n against the TPU's, by T: 0.1% up to T=100; the
# runs at T >= 200 part further (0.14-0.67%: PERF.md), where 1% stays
# below the spread between independent seeds (probes/sweep_sensitivity.py)
SWEEP_TOLERANCE = ((100, 1e-3), (1000, 1e-2))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def multiset_digest(state) -> tuple:
    """An order-independent digest of the live particles' every field, ids
    included (int32 bit patterns): two sums over the rows of a row hash
    modulo 2^31 - 1, computed on the state's device."""
    import torch

    n = state.n_clamped
    words = torch.cat([
        state.pos[:n].contiguous().view(torch.int32),
        state.vel[:n].contiguous().view(torch.int32),
        state.acc[:n].contiguous().view(torch.int32),
        state.status[:n, None], state.id_hi[:n, None], state.id_lo[:n, None],
    ], 1).to(torch.int64)
    m = (1 << 31) - 1
    out = []
    for base in (1_000_003, 998_244_353):
        mult = torch.tensor([pow(base, j + 1, m) for j in range(12)],
                            dtype=torch.int64, device=words.device)
        rows = ((words % m) * mult % m).sum(1) % m
        out.append(int(rows.sum()))
    return n, *out


def entry_points(dev, repo: str) -> dict:
    """Phase 8 (the module docstring): the entry points as a user calls
    them.  Returns each kernel's launches over 8a-8c."""
    import contextlib
    import hashlib
    import io
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from particle_simulation_tpu_torch import (
        benchmarks, checkpoint, cli, testing,
    )
    from particle_simulation_tpu_torch.observability import (
        CSV_HEADER, read_png,
    )
    from particle_simulation_tpu_torch.ops import grid as grid_ops
    from particle_simulation_tpu_torch.ops.kernels.field import (
        packed_field_gather,
    )
    from particle_simulation_tpu_torch.ops.kernels.push_mcc import staged_phase
    from particle_simulation_tpu_torch.ops.kernels.worklog import worklog_phase
    from particle_simulation_tpu_torch.runtime import multiset_with_ids

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    kernels = {"worklog_phase": worklog_phase, "staged_phase": staged_phase,
               "field_gather": packed_field_gather}
    total = dict.fromkeys(kernels, 0)

    def counted(tag, needed, fn):
        """``fn()`` with the launch counts at 0 before it, read after it;
        each kernel in ``needed`` must have launched."""
        for k in kernels.values():
            k.launches = 0
        out = fn()
        got = {name: k.launches for name, k in kernels.items()}
        for name, n in got.items():
            total[name] += n
        log(f"8{tag} launches: {got}")
        if on_card:
            check(all(got[k] > 0 for k in needed),
                  f"8{tag}: a kernel of its path was not launched: {got}")
        return out

    def sha(path):
        with open(os.path.join(repo, path), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    tracked = {p: sha(p) for p in TRACKED_CSVS}

    def counters(run):
        return [(m.n, m.added, m.removed, m.overflow, m.pushes)
                for m in run.steps]

    # ---- 8a. the test mode ----
    t0 = time.perf_counter()
    runs = {}
    run_pic = testing.run_pic

    def keep_first(cfg, *args, **kw):
        run = run_pic(cfg, *args, **kw)
        runs.setdefault(cfg.scheduler, run)  # sync: the base run
        return run

    out = io.StringIO()

    def test_mode():
        with contextlib.redirect_stdout(out):
            return cli.main(TEST_ARGV)

    testing.run_pic = keep_first
    try:
        rc = counted("a", kernels, test_mode)
    finally:
        testing.run_pic = run_pic
    lines = out.getvalue().splitlines()
    for line in lines:
        if line:
            log(f"  8a | {line}")
    check(rc == 0, f"8a: the test mode returned {rc}")
    check(sum(": success (" in line for line in lines) == 4,
          "8a: not four success lines")
    for sched, run in runs.items():
        check(not any(m.overflow for m in run.steps),
              f"8a: {sched} overflowed at capacity {TEST_ARGV[5]}")
        log(f"  8a {sched}: final n {run.final_n}, device time "
            f"{run.device_time_ms:.1f} ms over {len(run.steps)} steps")
    dyn, old = runs["dynamic"], runs["dynamic_old"]
    check(counters(dyn) == counters(old),
          f"8a: dynamic counters {counters(dyn)} vs dynamic_old "
          f"{counters(old)}")
    check(np.array_equal(multiset_with_ids(dyn.state),
                         multiset_with_ids(old.state)),
          "8a: dynamic and dynamic_old multisets differ")
    runs.clear()
    log(f"8a: test mode at capacity {TEST_ARGV[5]} (init n {TEST_ARGV[2]}, "
        f"{TEST_ARGV[8]}, T={TEST_ARGV[7]}): four successes; dynamic "
        "equal to dynamic_old (multiset with ids, per-step counters); "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 8b. modes 30 and 33 as subprocesses, checkpoints, resume ----
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pst_entry_points_")
    procs = {}
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, env.get("PYTHONPATH")) if p)
        steps = int(CLI_ARGV[3])
        # mode 33 logs only its first and final states (verbose = steps)
        cadence = {CLI_ARGV[0]: int(CLI_ARGV[1]), "33": steps}
        for mode, verbose in cadence.items():
            cwd = os.path.join(tmp, mode)
            os.makedirs(cwd)
            argv = [mode, str(verbose), *CLI_ARGV[2:],
                    f"ckpt={os.path.join(cwd, 'ckpt')}"]
            log(f"  8b: python -m particle_simulation_tpu_torch "
                f"{' '.join(argv)}")
            procs[mode] = subprocess.Popen(
                [sys.executable, "-m", "particle_simulation_tpu_torch", *argv],
                cwd=cwd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        for mode, proc in procs.items():
            text, _ = proc.communicate(timeout=600)
            for line in text.splitlines()[-8:]:
                log(f"  8b {mode} | {line}")
            check(proc.returncode == 0,
                  f"8b: mode {mode} exited {proc.returncode}")
        for mode, verbose in cadence.items():
            want = list(range(0, steps + 1, verbose))
            ckpt = os.path.join(tmp, mode, "ckpt")
            pngs = os.path.join(tmp, mode, "out", "visualization")
            check(sorted(os.listdir(ckpt))
                  == [f"step_{t:06d}.npz" for t in want],
                  f"8b: mode {mode} checkpoints {sorted(os.listdir(ckpt))}")
            check(sorted(os.listdir(pngs))
                  == [f"test_{t:04d}.png" for t in want],
                  f"8b: mode {mode} PNGs {sorted(os.listdir(pngs))}")
            for name in sorted(os.listdir(pngs)):
                img = read_png(os.path.join(pngs, name))
                check(img.shape == (512, 512, 3) and img.any(),
                      f"8b: {name} of mode {mode} is {img.shape}, blank "
                      f"{not img.any()}")
            log(f"  8b mode {mode}: checkpoints and PNGs at steps {want}, "
                "every PNG decoded")
        ckpt = os.path.join(tmp, CLI_ARGV[0], "ckpt")
        final, step = checkpoint.load_npz(
            os.path.join(ckpt, f"step_{steps:06d}.npz"), dev)
        check(step == steps, f"8b: final checkpoint at step {step}")
        resume_dir = os.path.join(tmp, "resume")
        os.makedirs(resume_dir)
        shutil.copy(os.path.join(ckpt, "step_000002.npz"), resume_dir)
        cfg = cli.parse_args(CLI_ARGV).config
        resumed = counted(
            "b", ("worklog_phase", "field_gather"),
            lambda: checkpoint.resume_run(cfg, resume_dir, device=dev))
        check(len(resumed.steps) == steps - 2
              and resumed.final_n == final.n
              and np.array_equal(multiset_with_ids(resumed.state),
                                 multiset_with_ids(final)),
              f"8b: the run resumed at step 2 (n {resumed.final_n}) differs "
              f"from the uninterrupted one (n {final.n})")
        old, _ = checkpoint.load_npz(
            os.path.join(tmp, "33", "ckpt", f"step_{steps:06d}.npz"), dev)
        check(np.array_equal(multiset_with_ids(old),
                             multiset_with_ids(final)),
              "8b: mode 33's final state differs from mode 30's")
        log(f"8b: modes 30 and 33 exit 0; the resume from step 2 equals the "
            f"uninterrupted run (n {final.n}, multiset with ids); mode 33 "
            f"equals mode 30; {time.perf_counter() - t0:.1f} s")
        del final, old, resumed

        # ---- 8c. the canonical sweep ----
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.empty_cache()
        seen = {}
        bench_run_pic = benchmarks.run_pic

        def measured(cfg, *args, **kw):
            grid_ops.field_counts.reset()
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            run = bench_run_pic(cfg, *args, **kw)
            peak = torch.cuda.max_memory_allocated(dev) if on_card else None
            seen[id(run)] = (grid_ops.field_counts.as_dict(), peak,
                             multiset_digest(run.state))
            return run

        out_csv = os.path.join(tmp, "sweep.csv")
        benchmarks.run_pic = measured
        try:
            sweep = counted("c", kernels, lambda: benchmarks.run_benchmark(
                out_csv=out_csv, device=dev, **SWEEP))
        finally:
            benchmarks.run_pic = bench_run_pic
        with open(out_csv) as f:
            header = f.readline().strip()
        check(header == CSV_HEADER, f"8c: CSV header {header!r}")
        tpu = {}
        with open(os.path.join(repo, TPU_CSV)) as f:
            for line in f.readlines()[1:]:
                parts = line.strip().split(",")
                tpu.setdefault((parts[0], int(parts[3])), int(parts[7]))
        by_key, off = {}, []
        for run in sweep:
            c = run.config
            paths, peak, digest = seen[id(run)]
            ref = tpu[(run.function, c.poisson_timestep)]
            rel = (run.final_n - ref) / ref
            bound = next(b for t_max, b in SWEEP_TOLERANCE
                         if c.poisson_timestep <= t_max)
            if abs(rel) > bound:
                off.append((run.function, c.poisson_timestep, rel, bound))
            ms = run.device_time_ms / len(run.steps)
            rate = sum(m.pushes for m in run.steps) / (
                run.device_time_ms / 1e3)
            memory = f"{peak / 1e9:.2f} GB" if peak is not None else "-"
            log(f"  8c {c.scheduler:11s} T={c.poisson_timestep:4d} final n "
                f"{run.final_n} (TPU {ref}, {run.final_n - ref:+d}, "
                f"{100 * rel:+.4f}%, bound {100 * bound:g}%) device_time_ms "
                f"{run.device_time_ms:.1f} "
                f"({ms:.2f} ms a Poisson step) {rate:.4e} pushes/s, peak "
                f"memory {memory}, field phases {paths}")
            by_key[(c.scheduler, c.poisson_timestep)] = (
                run.final_n, counters(run), digest)
        shared = sorted(t for s, t in by_key if s == "dynamic_old")
        check(shared, "8c: no dynamic_old row")
        for t in shared:
            check(by_key[("dynamic", t)] == by_key[("dynamic_old", t)],
                  f"8c T={t}: dynamic and dynamic_old differ")
        check(not off, f"8c: final n off the TPU's beyond its bound "
              f"(function, T, relative difference, bound): {off}")
        log(f"8c: {len(sweep)} rows, each final n within its bound of the "
            f"TPU's ((largest T, bound): {SWEEP_TOLERANCE}); dynamic equal to "
            f"dynamic_old at T={shared} (final n, per-step counters, "
            f"multiset digest); {time.perf_counter() - t0:.1f} s")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    check({p: sha(p) for p in TRACKED_CSVS} == tracked,
          "8: a tracked CSV changed")
    log(f"8: entry points done in {time.perf_counter() - t_phase:.1f} s; "
        "the tracked CSVs unchanged")
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from particle_simulation_tpu_torch import SimConfig, cross_section
    from particle_simulation_tpu_torch.ops import grid as grid_ops
    from particle_simulation_tpu_torch.ops.kernels import (
        build, compact, lookup_bench, sublane_gather,
    )
    from particle_simulation_tpu_torch.ops.kernels.field import (
        banded_gather, banded_gather_plain, packed_field_gather,
        packed_field_gather_plain,
    )
    from particle_simulation_tpu_torch.ops.kernels.push_mcc import (
        mobility_phase_dynamic, mobility_phase_dynamic_plain, staged_phase,
    )
    from particle_simulation_tpu_torch.ops.kernels.worklog import (
        mobility_phase_worklog, mobility_phase_worklog_plain, worklog_phase,
    )
    from particle_simulation_tpu_torch.ops.population import is_live
    from particle_simulation_tpu_torch.ops.step import (
        grid_phase, poisson_loop, poisson_step,
    )
    from particle_simulation_tpu_torch.probes import (
        experiment_sublane_gather, experiment_worklog, microbench_lookup,
    )
    from particle_simulation_tpu_torch.probes import (
        microbench_fieldgather as probe,
    )
    from particle_simulation_tpu_torch.probes.common import (
        bound_ms, bound_terms, card,
    )
    from particle_simulation_tpu_torch.runtime import multiset_with_ids
    from particle_simulation_tpu_torch.state import setup_particles

    dev = torch.device("cuda", 0)

    # ---- 2. the card ----
    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 3. build ----
    lib = build.load()
    log(f"build: {lib.build_seconds:.1f} s -> {os.path.relpath(lib.path)}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    sine = cross_section.load_table(cross_section.bundled_paths()[0], dev)
    const = cross_section.load_table(cross_section.bundled_paths()[1], dev)

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop)

    def device_allocs():
        """The caching allocator's cudaMalloc and cudaFree calls so far."""
        stats = torch.cuda.memory_stats(dev)
        return (stats.get("num_device_alloc", -1),
                stats.get("num_device_free", -1))

    max_err = 0.0
    staged_err = 0.0

    def multiset_err(tag, ks, ps):
        """Multiset + ids of two states; returns the max abs difference of
        the float fields."""
        a, b = multiset_with_ids(ks), multiset_with_ids(ps)
        check(a.shape == b.shape, f"{tag}: n {ks.n} vs {ps.n}")
        err = float(np.max(np.abs(a[:, :9].view(np.float32)
                                  - b[:, :9].view(np.float32)), initial=0.0))
        check(np.array_equal(a, b), f"{tag}: multiset differs (max {err})")
        return err

    def compare(tag, k_out, p_out):
        """Kernel vs plain on one phase: multiset + ids + counters."""
        nonlocal max_err
        (ks, ki), (ps, pi) = k_out, p_out
        max_err = max(max_err, multiset_err(tag, ks, ps))
        keys = ("added", "removed", "overflow", "pushes_lo", "pushes_hi")
        kc = {"n": ks.n, **{k: ki[k] for k in keys}}
        pc = {"n": ps.n, **{k: pi[k] for k in keys}}
        check(kc == pc, f"{tag}: counters {kc} vs plain {pc}")
        check(not kc["overflow"], f"{tag}: overflow")
        return kc

    def phase_work(n_in, n_out, pushes):
        """(bytes, operations) of a mobility phase: its population in and
        out once, the table once, OPS_PER_PUSH a lane-step."""
        table_bytes = cross_section.N_STEPS * 8
        return (RECORD_BYTES * (n_in + n_out) + table_bytes,
                OPS_PER_PUSH * pushes)

    def kernel_vs_plain(tag, cfg, table, steps):
        """Both phases on the same grid-phase output each step; returns the
        per-step phase times (ms) of the kernel and the plain version, and
        each step's (bytes, operations)."""
        st = setup_particles(cfg, device=dev)
        k_ms, p_ms, work = [], [], []
        for s in range(steps):
            st = grid_phase(st, cfg)
            mallocs = device_allocs()
            k_out, kt = timed(mobility_phase_worklog, st, s, table, cfg,
                              cfg.poisson_timestep)
            mallocs = [b - a for a, b in zip(mallocs, device_allocs())]
            p_out, pt = timed(mobility_phase_worklog_plain, st, s, table, cfg,
                              cfg.poisson_timestep)
            c = compare(f"{tag} step {s}", k_out, p_out)
            pushes = c['pushes_lo'] + (c['pushes_hi'] << 30)
            log(f"  {tag} step {s}: equal, n={c['n']} added={c['added']} "
                f"removed={c['removed']} pushes={pushes} "
                f"kernel {kt:.2f} ms (cudaMalloc {mallocs[0]}, cudaFree "
                f"{mallocs[1]}) plain {pt:.2f} ms")
            k_ms.append(kt)
            p_ms.append(pt)
            work.append(phase_work(st.n, c["n"], pushes))
            st = k_out[0]
        return k_ms, p_ms, work

    # ---- 4. kernel vs plain ----
    for depth in (2, 1):
        cfg = SimConfig(**CHURN, spawn_depth=depth)
        kernel_vs_plain(f"4a const d{depth}", cfg, const, 3)
    log("4a: kernel equal to plain (const table, spawn_depth 2 and 1)")
    main_cfg = SimConfig(**MAIN)
    k_ms, p_ms, work = kernel_vs_plain("4b main", main_cfg, sine, 4)
    log("4b: kernel equal to plain (main-path config, 4 steps)")
    # phase times at the main path's shapes, first step as warm-up: the
    # mean is the line's number; the median beside it shows a stall
    kernel_ms, plain_ms = (sum(x[1:]) / len(x[1:]) for x in (k_ms, p_ms))
    kernel_median, plain_median = (sorted(x[1:])[len(x[1:]) // 2]
                                   for x in (k_ms, p_ms))
    worklog_work = [sum(w[i] for w in work[1:]) / len(work[1:])
                    for i in (0, 1)]

    # ---- 4c/4d. the staged kernel, through Poisson steps ----
    def timed_phase(fn, record):
        """``fn`` as a mobility phase that records (ms, info) per call."""
        def phase(*args):
            out, ms = timed(fn, *args)
            record.append((ms, out[1]))
            return out
        phase.self_compacting = getattr(fn, "self_compacting", False)
        return phase

    def same_bits(a, b):
        a, b = a.cpu().contiguous(), b.cpu().contiguous()
        return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def step_compare(tag, a, b, bitwise=False):
        """Two Poisson steps from one state: multiset + ids + the six
        counters; with ``bitwise``, every output tensor too."""
        nonlocal staged_err
        (sa, ma), (sb, mb) = a, b
        staged_err = max(staged_err, multiset_err(tag, sa, sb))
        check(ma == mb, f"{tag}: counters {ma} vs {mb}")
        check(not ma["overflow"], f"{tag}: overflow")
        if bitwise:
            check(all(same_bits(x, y) for x, y in zip(sa[:6], sb[:6])),
                  f"{tag}: output tensors differ")

    for depth in (2, 1):
        cfg = SimConfig(**dict(CHURN, scheduler="dynamic_old"),
                        spawn_depth=depth)
        st = setup_particles(cfg, device=dev)
        for s in range(3):
            kr, pr = [], []
            a = poisson_step(st, s, const, cfg,
                             phase=timed_phase(mobility_phase_dynamic, kr))
            b = poisson_step(st, s, const, cfg,
                             phase=timed_phase(mobility_phase_dynamic_plain, pr))
            step_compare(f"4c const d{depth} step {s}", a, b, bitwise=True)
            m, info = a[1], kr[0][1]
            check(info == pr[0][1],
                  f"4c const d{depth} step {s}: {info} vs plain {pr[0][1]}")
            log(f"  4c const d{depth} step {s}: equal bit for bit, n={m['n']} "
                f"added={m['added']} removed={m['removed']} "
                f"passes={info['passes']} reclaimed={info['reclaimed']} "
                f"kernel {kr[0][0]:.2f} ms plain {pr[0][0]:.2f} ms")
            st = a[0]
    log("4c: staged kernel equal to plain, output tensors bit for bit (const "
        "table, spawn_depth 2 and 1)")

    old_cfg = SimConfig(**dict(MAIN, scheduler="dynamic_old"))
    st = setup_particles(old_cfg, device=dev)
    staged_k_ms, staged_work = [], []
    staged_plain_ms = None
    for s in range(4):
        kr, pr = [], []
        launches = staged_phase.launches
        a = poisson_step(st, s, sine, old_cfg,
                         phase=timed_phase(mobility_phase_dynamic, kr))
        launches = staged_phase.launches - launches
        check(launches == 1, f"4d step {s}: {launches} staged launches")
        step_compare(f"4d step {s} vs dynamic", a,
                     poisson_step(st, s, sine, main_cfg))
        m, (k_ms, info) = a[1], kr[0]
        line = (f"  4d main step {s}: equal to dynamic, n={m['n']} "
                f"added={m['added']} removed={m['removed']} launches="
                f"{launches} passes={info['passes']} reclaims="
                f"{staged_phase.last['reclaims']} reclaimed="
                f"{info['reclaimed']} kernel {k_ms:.2f} ms")
        if s < 2:
            step_compare(f"4d step {s} vs plain", a, poisson_step(
                st, s, sine, old_cfg,
                phase=timed_phase(mobility_phase_dynamic_plain, pr)))
            check(info == pr[0][1], f"4d step {s}: {info} vs plain "
                  f"{pr[0][1]}")
            line += f", equal to plain {pr[0][0]:.2f} ms"
        if s == 1:  # where the MCC first adds ~1M children
            staged_plain_ms = pr[0][0]
        if s:
            staged_k_ms.append(k_ms)
            staged_work.append(phase_work(
                st.n, m["n"], m["pushes_lo"] + (m["pushes_hi"] << 30)))
        log(line)
        st = a[0]
    # as 4b: steps 1-3, the mean is the line's number, the median beside it
    staged_ms = sum(staged_k_ms) / len(staged_k_ms)
    staged_median = sorted(staged_k_ms)[len(staged_k_ms) // 2]
    staged_work = [sum(w[i] for w in staged_work) / len(staged_work)
                   for i in (0, 1)]
    log("4d: dynamic_old kernel equal to the dynamic kernel (4 steps) and to "
        "its plain version (steps 0-1), main-path config; one launch a "
        f"phase; kernel phase at step 1 {staged_k_ms[0]:.2f} ms, steps 1-3 "
        f"mean {staged_ms:.2f} ms, median {staged_median:.2f} ms; plain at "
        f"step 1 {staged_plain_ms:.2f} ms")

    # ---- 4e. the field gather ----
    def on_cpu(st):
        return st._replace(**{f: getattr(st, f).cpu() for f in
                              ("pos", "vel", "acc", "status", "id_hi", "id_lo")})

    def gather_inputs(st, cfg):
        """The packed subgrid table, ids and weights that the field phase's
        gather takes at ``st`` (the subgrid path)."""
        m, S = st.n_clamped, cfg.bbox_subgrid
        weight = is_live(st.status[:m]).to(torch.int32)
        idx = grid_ops.cell_indices(st.pos[:m], cfg.cell_size, cfg.grid_size)
        origin, fits = grid_ops.bbox_window(idx, weight, cfg.grid_size, S)
        check(fits, "4e: the main path's box does not fit the window")
        flat = grid_ops.subgrid_ids(idx, weight, origin, S)
        counts = grid_ops.subgrid_deposit(flat, S)
        packed = grid_ops.pack_diffs(*grid_ops._int_diffs(counts, (S,) * 3))
        return packed, flat, weight

    field_err = 0.0
    inp = probe.make_inputs(device=dev)
    for order, ids in (("sorted", inp.ids_sorted), ("random", inp.ids)):
        rows, lanes = probe.split(ids)
        k = banded_gather(inp.table, rows, lanes)
        check(torch.equal(k, banded_gather_plain(inp.table, rows, lanes)),
              f"4e banded_gather, {order} ids: differs from plain")
        log(f"  4e banded_gather, {order} ids (N={ids.numel()}, table "
            f"{tuple(inp.table.shape)}): equal, kernel "
            f"{probe.time_ms(banded_gather, inp.table, rows, lanes):.4f} ms "
            f"plain "
            f"{probe.time_ms(banded_gather_plain, inp.table, rows, lanes):.4f}"
            " ms")
    full_cfg = main_cfg.replace(bbox_subgrid=0)
    e_const = main_cfg.electric_force_constant
    st = setup_particles(main_cfg, device=dev)
    gather_ms, gather_plain_ms, gather_work = [], [], []
    for s in range(3):
        grid_ops.field_counts.reset()
        k_acc = grid_phase(st, main_cfg).acc
        path = grid_ops.field_counts.last
        readbacks = grid_ops.field_counts.readbacks
        check(s > 0 or path == "subgrid",
              f"4e step 0 took the {path} path, not the subgrid")
        check(same_bits(k_acc, grid_phase(on_cpu(st), main_cfg).acc),
              f"4e step {s}: kernel field phase differs from the plain one")
        check(same_bits(k_acc, grid_phase(st, full_cfg).acc),
              f"4e step {s}: subgrid field phase differs from the full grid")
        line = (f"  4e main step {s}: n={st.n} path={path} "
                f"readbacks={readbacks}, equal to plain and to the full grid")
        if path == "subgrid":
            args = (*gather_inputs(st, main_cfg), e_const)
            kg = packed_field_gather(*args)
            pg = packed_field_gather_plain(*args)
            check(same_bits(kg, pg), f"4e step {s}: packed_field_gather "
                  "differs from plain")
            field_err = max(field_err, float((kg - pg).abs().max()))
            gather_ms.append(probe.time_ms(packed_field_gather, *args))
            gather_plain_ms.append(probe.time_ms(packed_field_gather_plain,
                                                 *args))
            packed, flat = args[0], args[1]
            gather_work.append((flat.numel() * (4 + 4 + 12)
                                + packed.numel() * 4,
                                flat.numel() * FIELD_OPS))
            line += (f"; packed_field_gather equal, kernel {gather_ms[-1]:.4f}"
                     f" ms plain {gather_plain_ms[-1]:.4f} ms")
        log(line)
        st = poisson_step(st, s, sine, main_cfg)[0]
    check(gather_ms, "4e: no step took the subgrid path")
    field_ms = sum(gather_ms) / len(gather_ms)
    field_plain_ms = sum(gather_plain_ms) / len(gather_plain_ms)
    field_work = [sum(w[i] for w in gather_work) / len(gather_work)
                  for i in (0, 1)]
    log("4e: field gather equal to plain; main-path field phase equal to "
        "plain and to the full grid (steps 0-2)")

    # ---- 4f. the field phase's fallbacks ----
    cfg16 = SimConfig(**CHURN, bbox_subgrid=16)
    st = setup_particles(cfg16, device=dev)
    grid_ops.field_counts.reset()
    a = grid_phase(st, cfg16).acc
    check(grid_ops.field_counts.last == "window_fallback",
          "4f: the 62-cell cube fitted a 16^3 window")
    check(same_bits(a, grid_phase(st, cfg16.replace(bbox_subgrid=0)).acc),
          "4f window fallback differs from the full grid")
    check(same_bits(a, grid_phase(on_cpu(st), cfg16).acc),
          "4f window fallback differs from the CPU")
    log("  4f window fallback (const churn, bbox_subgrid=16): taken, equal "
        "to the full grid and the CPU")
    cfg = SimConfig(**CHURN)
    st = setup_particles(cfg, device=dev)
    st.pos[:600] = 32.5 * cfg.cell_size  # 600 charges in cell (32, 32, 32)
    grid_ops.field_counts.reset()
    a = grid_phase(st, cfg).acc
    check(grid_ops.field_counts.last == "subgrid"
          and grid_ops.field_counts.rows_fallback == 1,
          f"4f: 10-bit fallback not taken {grid_ops.field_counts.as_dict()}")
    check(same_bits(a, grid_phase(st, cfg.replace(bbox_subgrid=0)).acc),
          "4f 10-bit fallback differs from the full grid")
    check(same_bits(a, grid_phase(on_cpu(st), cfg).acc),
          "4f 10-bit fallback differs from the CPU")
    log("  4f 10-bit fallback (600 charges in one cell): taken on the subgrid "
        "and the full grid, equal to the full grid and the CPU")
    log("4f: both field-phase fallbacks equal to the full grid")

    # ---- 5. the main path ----
    def drive(cfg, phase, timed_steps=3):
        """1 warm and ``timed_steps`` timed Poisson steps from the seed
        state, CUDA events around each (a step ends in its readbacks);
        returns the mean and median step ms, pushes/s over the timed
        steps, the final state and their metrics."""
        st = setup_particles(cfg, device=dev)
        st, warm = poisson_loop(st, sine, cfg, 1, phase=phase)
        ms, m = [], {}
        for i in range(timed_steps):
            (st, mi), t = timed(poisson_loop, st, sine, cfg, 1, 1 + i, phase)
            ms.append(t)
            for k, v in mi.items():
                m.setdefault(k, []).extend(v)
        pushes = sum(lo + (hi << 30)
                     for lo, hi in zip(m["pushes_lo"], m["pushes_hi"]))
        check(not any(warm["overflow"] + m["overflow"]), "main path overflow")
        check(st.n == m["n"][-1] and 0 < st.n <= cfg.capacity,
              f"main path n={st.n}")
        n = st.n
        live = torch.cat([st.pos[:n], st.vel[:n], st.acc[:n]], 1)
        check(bool(torch.isfinite(live).all()), "non-finite particle state")
        check(bool((st.status[:n] == -1).all()), "dead slot in population")
        size = cfg.sim_size[0]
        check(bool(((st.pos[:n] >= 0) & (st.pos[:n] < size)).all()),
              "particle outside the domain")
        log(f"  steps 1-{timed_steps} ms: "
            + ", ".join(f"{t:.3f}" for t in ms))
        return (sum(ms) / len(ms), sorted(ms)[len(ms) // 2],
                pushes / (sum(ms) / 1e3), st, m)

    def field_paths(tag, steps):
        c = grid_ops.field_counts.as_dict()
        check(sum(grid_ops.field_counts.paths.values()) == steps,
              f"{tag}: {c} for {steps} field phases")
        log(f"{tag} field paths over its {steps} steps: {c}")

    def field_phase_ms(tag, st, cfg, reps=6):
        """Median host ms of the field phase on ``st``, the subgrid and the
        full-grid path alternated (warm-up first)."""
        cfgs = {f"bbox_subgrid={cfg.bbox_subgrid}": cfg,
                "bbox_subgrid=0": cfg.replace(bbox_subgrid=0)}
        ms = {k: [] for k in cfgs}
        paths = {}
        for i in range(reps + 1):
            for k in (list(cfgs) if i % 2 else list(cfgs)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grid_phase(st, cfgs[k])
                torch.cuda.synchronize()
                paths[k] = grid_ops.field_counts.last
                if i:
                    ms[k].append((time.perf_counter() - t0) * 1e3)
        log(f"{tag} field phase at its final n={st.n}, alternated, median of "
            f"{reps}: " + ", ".join(
                f"{k} ({paths[k]}) {sorted(v)[len(v) // 2]:.3f} ms "
                f"[{min(v):.3f}-{max(v):.3f}]" for k, v in ms.items()))

    def profile_phases(tag, st, cfg, first_step, phase, wrapper, steps=3):
        """The mobility phase ``phase`` (whose kernel wrapper ``wrapper``
        keeps the last phase's result words) of ``steps`` further Poisson
        steps from ``st``, run on the same input (its grid phase's output)
        once timed
        on the host from the call to a synchronize, then twice under one
        torch.profiler session, which slows the host but shows the device.
        Of the second profiled run (the first takes the profiler's own
        start-up work): its span on the host (a record_function around the
        call, which returns after its readback), the device's busy time
        inside that span (the union of the kernels and copies), the
        kernels launched and the device-to-host copies.  The busy share is
        busy time over span, both of that run.  Returns the mean share, or
        None where the profiler saw no device activity."""
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.autograd.DeviceType.CUDA
        shares = []
        for s in range(steps):
            g = grid_phase(st, cfg)
            args = (g, first_step + s, sine, cfg, cfg.poisson_timestep)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, info = phase(*args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    with record_function("mobility_phase"):
                        again = phase(*args)
                    torch.cuda.synchronize()
            check(again[1] == info and again[0].n == st.n,
                  f"{tag}: a second run of phase {first_step + s} differs")
            events = prof.events()
            span = max((e.time_range for e in events
                        if e.name == "mobility_phase"
                        and e.device_type != cuda), key=lambda r: r.start)
            # the second run's device events, without the annotation's own
            # copy there
            spans = sorted((e.time_range.start, e.time_range.end, e.name)
                           for e in events if e.device_type == cuda
                           and e.name != "mobility_phase"
                           and e.time_range.end > span.start)
            busy_us, end = 0.0, span.start
            for a, b, _ in spans:  # the union, clipped to the span
                b = min(b, span.end)
                busy_us += max(0.0, b - max(a, end))
                end = max(end, b)
            span_ms = (span.end - span.start) / 1e3
            names = [name for _, _, name in spans]
            copies = [x for x in names if x.startswith("Memcpy")]
            readbacks = sum("DtoH" in x for x in copies)
            kernels = [x for x in names
                       if not x.startswith(("Memcpy", "Memset"))]
            last = wrapper.last
            reclaims = (f", {last['reclaims']} reclaims" if "reclaims" in last
                        else "")
            line = (f"{tag} mobility phase {first_step + s}: wall "
                    f"{wall_ms:.3f} ms, grid of {last['blocks']} blocks, "
                    f"{last['passes']} passes on the card{reclaims}; "
                    f"profiled run: span {span_ms:.3f} ms, ")
            if spans:
                shares.append(busy_us / 1e3 / span_ms)
                line += (f"device busy {busy_us / 1e3:.3f} ms "
                         f"({100 * shares[-1]:.1f}%), kernel launches "
                         f"{len(kernels)}, readbacks {readbacks}, other "
                         "device ops "
                         f"{len(names) - len(kernels) - readbacks}"
                         f"; kernels {sorted(set(kernels))}")
            else:
                line += "device busy not measured (no device events)"
            log(line)
        return sum(shares) / len(shares) if shares else None

    worklog_phase.launches = 0
    worklog_phase.passes = 0
    packed_field_gather.launches = 0
    grid_ops.field_counts.reset()
    step_ms, step_median, rate, st, m = drive(main_cfg, None)
    n = st.n
    launches_worklog = worklog_phase.launches
    passes_worklog = worklog_phase.passes
    field_launches = packed_field_gather.launches
    check(launches_worklog == 4,
          f"{launches_worklog} work-log launches in 4 mobility phases")
    check(passes_worklog > launches_worklog,
          "the main path's phases counted no chained passes")
    check(field_launches > 0,
          "the main path did not launch the field-gather kernel")
    log(f"5 main path (kernel): {step_ms:.2f} ms/Poisson step (median "
        f"{step_median:.2f}), {rate:.4e} pushes/s, final n={n}, "
        f"overflow=False, worklog_phase launches={launches_worklog} "
        f"({launches_worklog / 4:g} a phase), device-counted passes="
        f"{passes_worklog} ({passes_worklog / 4:g} a phase), "
        f"packed_field_gather launches={field_launches}, "
        f"added={m['added']} removed={m['removed']}")
    field_paths("5 main path", 4)
    field_phase_ms("5 main path", st, main_cfg)
    busy = profile_phases("5 main path", st, main_cfg, 4,
                          mobility_phase_worklog, worklog_phase)
    plain_step_ms, _, plain_rate, plain_st, _ = drive(
        main_cfg, mobility_phase_worklog_plain)
    check(plain_st.n == n, f"plain final n {plain_st.n} vs kernel {n}")
    log(f"5 main path (plain): {plain_step_ms:.2f} ms/Poisson step, "
        f"{plain_rate:.4e} pushes/s, final n={plain_st.n}")
    log(f"mobility phase at the main path (4b, steps 1-3): kernel mean "
        f"{kernel_ms:.2f} ms, median {kernel_median:.2f} ms; plain mean "
        f"{plain_ms:.2f} ms, median {plain_median:.2f} ms")

    staged_phase.launches = 0
    staged_phase.passes = 0
    staged_phase.reclaims = 0
    packed_field_gather.launches = 0
    grid_ops.field_counts.reset()
    old_ms, old_median, old_rate, old_st, old_m = drive(old_cfg, None)
    staged_launches = staged_phase.launches
    passes_staged = staged_phase.passes
    reclaims_staged = staged_phase.reclaims
    check(staged_launches == 4,
          f"{staged_launches} staged launches in 4 mobility phases")
    check(passes_staged > staged_launches,
          "5b: the staged phases counted no chained passes")
    check(packed_field_gather.launches > 0,
          "5b did not launch the field-gather kernel")
    check(old_st.n == n, f"dynamic_old final n {old_st.n} vs dynamic {n}")
    log(f"5b main path dynamic_old (kernel): {old_ms:.2f} ms/Poisson step "
        f"(median {old_median:.2f}), {old_rate:.4e} pushes/s, final "
        f"n={old_st.n}, overflow=False, staged_phase launches="
        f"{staged_launches} ({staged_launches / 4:g} a phase, one readback "
        f"each), device-counted passes={passes_staged} "
        f"({passes_staged / 4:g} a phase), reclaims={reclaims_staged} "
        f"({reclaims_staged / 4:g} a phase), packed_field_gather "
        f"launches={packed_field_gather.launches}, added={old_m['added']} "
        f"removed={old_m['removed']}")
    field_paths("5b main path dynamic_old", 4)
    field_phase_ms("5b main path dynamic_old", old_st, old_cfg)
    old_busy = profile_phases("5b main path dynamic_old", old_st, old_cfg, 4,
                              mobility_phase_dynamic, staged_phase)
    old_plain_ms, _, old_plain_rate, old_plain_st, _ = drive(
        old_cfg, mobility_phase_dynamic_plain, timed_steps=1)
    log(f"5b main path dynamic_old (plain): {old_plain_ms:.2f} ms/Poisson "
        f"step over 1 step, {old_plain_rate:.4e} pushes/s, "
        f"final n={old_plain_st.n}")

    # ---- 6. the field-gather probe ----
    for label, value in probe.run(dev):
        log(f"6 {label:44s} {value}")

    def bounds(name, n_bytes, n_ops):
        """The kernel line's bound keys, after a line with both terms."""
        by_bytes, by_ops = bound_terms(n_bytes, n_ops)
        bound, by = bound_ms(n_bytes, n_ops)
        log(f"bound {name}: {n_bytes:.6g} B -> {by_bytes:.4f} ms, "
            f"{n_ops:.6g} operations -> {by_ops:.4f} ms; {by} set it")
        return {"bound_ms": bound, "bound_by": by}

    # ---- 7. the probes of the remaining kernels ----
    counted = (compact.row_compact, sublane_gather.sublane_gather,
               lookup_bench.lookup_bench)
    probes = (
        ("row_compact", experiment_worklog, compact.row_compact,
         "compact.cu", "scripts/experiment_worklog.py:25"),
        ("sublane_gather", experiment_sublane_gather,
         sublane_gather.sublane_gather, "sublane_gather.cu",
         "scripts/experiment_sublane_gather.py:23"),
        ("lookup_bench", microbench_lookup, lookup_bench.lookup_bench,
         "lookup_bench.cu", "scripts/microbench_lookup.py:79"),
    )
    probe_entries = []
    for name, mod, wrapper, source, replaces in probes:
        t0 = time.perf_counter()
        inp = mod.make_inputs(device=dev)
        err = mod.check(inp)  # bitwise against the plain twin; raises
        for fn in counted:
            fn.launches = 0
        timing = mod.timings(inp)  # the probe's path, counted
        launches = wrapper.launches
        check(launches > 0, f"7 {name}: the probe did not launch its kernel")
        for label, value in timing.lines:
            log(f"7 {label:60s} {value}")
        log(f"7 {name}: equal to plain (bitwise), launches={launches}, "
            f"kernel {timing.ms:.4f} ms, {time.perf_counter() - t0:.1f} s")
        probe_entries.append({
            "name": name,
            "route": "cuda",
            "source": f"particle_simulation_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": timing.ms,
            "plain_ms": timing.plain_ms,
            **bounds(name, timing.bytes, timing.ops),
            "library_ms": timing.library_ms,
            **(timing.extra or {}),
        })

    # ---- 8. the entry points ----
    entry = entry_points(dev, os.path.dirname(os.path.abspath(__file__)))

    log(json.dumps({"kernels": [{
        "name": "worklog_phase",
        "route": "cuda",
        "source": "particle_simulation_tpu_torch/csrc/worklog.cu",
        "replaces": "particle_simulation_tpu/ops/pallas/worklog.py:302",
        "launches": launches_worklog,
        "launches_entry_points": entry["worklog_phase"],
        "passes": passes_worklog,
        "device_busy_share": busy,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "ms_median": kernel_median,
        "plain_ms": plain_ms,
        "plain_ms_median": plain_median,
        **bounds("worklog_phase", *worklog_work),
        "library_ms": None,
    }, {
        "name": "staged_phase",
        "route": "cuda",
        "source": "particle_simulation_tpu_torch/csrc/staged.cu",
        "replaces": "particle_simulation_tpu/ops/pallas/push_mcc.py:1113",
        "launches": staged_launches,
        "launches_entry_points": entry["staged_phase"],
        "passes": passes_staged,
        "reclaims": reclaims_staged,
        "device_busy_share": old_busy,
        "max_abs_err": staged_err,
        "ms": staged_ms,
        "ms_median": staged_median,
        "ms_step1": staged_k_ms[0],
        "plain_ms": staged_plain_ms,
        **bounds("staged_phase", *staged_work),
        "library_ms": None,
    }, {
        "name": "field_gather",
        "route": "cuda",
        "source": "particle_simulation_tpu_torch/csrc/field.cu",
        "replaces": "scripts/microbench_fieldgather.py:40",
        "launches": field_launches,
        "launches_entry_points": entry["field_gather"],
        "max_abs_err": field_err,
        "ms": field_ms,
        "plain_ms": field_plain_ms,
        **bounds("field_gather", *field_work),
        "library_ms": None,
    }, *probe_entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
