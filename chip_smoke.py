#!/usr/bin/env python3
"""Chip check of the PyTorch + CUDA port (particle_simulation_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, each printing one line or a few:

1. require CUDA (there is no CPU path);
2. the card's name and power limit (nvidia-smi);
3. build the kernels (csrc/worklog.cu, staged.cu, field.cu, compact.cu,
   sublane_gather.cu and lookup_bench.cu, one nvcc process each, in
   parallel) and print the build time and each kernel's registers, stack
   and spills (probes/ptxas.py; the engines by their template arguments,
   the reference and the general instantiations);
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
9. the model menu (boris with and without a magnetic field, isotropic
   collisions, the periodic box, the thermal start, the argon-like table,
   the FFT field), through the kernels' general instantiations:
   (a) each model alone and all together at the const churn of 4a
       (spawn_depth 2 and 1, 2 steps), and a case that wraps (16^3,
       mobility_dt 1e-9, init_vth 1e6): each engine against its plain
       version and the two engines against each other, ids, statuses and
       counters exact, the float fields within MODEL_ULPS (the count of
       lanes that differ and their largest difference in ulps printed);
       then the lanes that wrapped, counted as those an absorbing box
       loses with no collisions (more than 0);
   (b) the magnetized-argon slice (SLICE: 1M electrons, capacity 4M,
       256^3, T=100, the argon-like table written to a file and loaded as
       the cross-section path) on dynamic and dynamic_old, 1 warm and 3
       timed steps (CUDA events, mean and median of the phases and the
       Poisson step), the launches, the device-counted passes and n,
       added, removed at each step; the engines equal at every step, each
       equal to its plain version at steps 0-1;
   (c) the slice with field_model="fft" for 2 steps on dynamic, the
       card's field against the CPU's within FFT_CARD_RTOL;
   (d) ``python -m particle_simulation_tpu_torch 30`` with the model knobs
       for 2 steps: exit 0, its final n equal to (b)'s.
10. the sharded path (parallel/sharded.py, ranks started by
    parallel/launch.py), its wall time bounded by SHARDED_BUDGET_S; each
    rank counts its own kernel launches and hands them back, and every
    rank must import nothing of JAX:
   (a) NCCL at world size 1, the main path (1M electrons, capacity 2M,
       256^3, T=100, dynamic) for 4 Poisson steps, replicated and slab
       (bbox_subgrid=64): the sorted multiset with ids and the per-step
       counters equal to the single-process ``poisson_loop``, exactly;
       worklog_phase (and packed_field_gather, replicated) launched in
       the rank; the ms a step, then again with the collectives timed:
       each collective's calls, bytes and ms a step;
   (b) two ranks sharing the card over gloo, 2 x 500k electrons, capacity
       2 x 1M: replicated and slab (32 planes a rank) on dynamic, and
       replicated on dynamic_old, each equal to (a) exactly (shard-count
       invariance on the card), staged_phase launched under dynamic_old;
       whether MPS runs, and the collectives gloo ran on host copies;
   (c) NCCL over 2 cards when the machine has them, equal to (a); on one
       card a line saying why it did not run;
   (d) ``python -m particle_simulation_tpu_torch 30 ... mesh=1`` at (a)'s
       size for 2 steps: exit 0, its final n equal to (a)'s.
11. the float64 oracle mode (``precision="f64"``: positions and
    velocities in float64 on the plain schedulers, no kernel; its field
    phase the float64 gather), its wall time bounded by F64_BUDGET_S;
    each run with the launch counts at 0 before it, every f64 run
    launching none:
   (a) tests/test_oracle.py's invariants on the card: with the const
       table, f32 ``dynamic`` (the kernel) and f32 ``sync`` against f64
       ``sync``: n, added and the id multiset exactly equal; with the
       sine table n equal, vel within rtol 2e-5 and pos within rtol 1e-5;
   (b) f64 at the main path's size (1M electrons, capacity 4M, 256^3,
       T=100, the sine table, 2 steps): ``sync`` equal to ``naive``
       (multiset with ids, per-step counters), each one's ms a step, and
       the final n beside the f32 ``dynamic`` run's;
   (c) f64 ``naive`` at the const churn of 4a for 2 steps, the card
       against the CPU: multiset with ids and counters, bit for bit (the
       CPU tests hold f64 to JAX bit for bit);
   (d) a float64 npz of an f64 run resumes (``checkpoint.resume_run``)
       equal to the uninterrupted run, and loads rounded by value under
       f32; ``python -m particle_simulation_tpu_torch 31 ...
       precision=f64`` exits 0, mode 30 exits non-zero with the engines'
       message;
   (e) ``probes/weak_scaling.py``: a row at each world size the cards
       allow (one card: world size 1 over NCCL, then its stop line).

Any failed check raises, so the script exits non-zero.  The last line is
the device record {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on their path, their times, the plain
version's and the library call's, and the bound: the least time the H100
could take for the same work, from the bytes each input and output must
move once (3.35 TB/s) and the operations these inputs need (67 TFLOP/s
float32), whichever is larger (probes/common.py); the line before that
repeats the card's name and power limit.  The two engines' lines
add the slice of 9b: ``models_ms`` (the phase's mean over steps 1-3),
``models_launches``, ``models_passes`` and ``models_bound_ms``; the
engines' and the field gather's lines add ``launches_sharded``, their
launches in the ranks of 10, and ``launches_phase11``, theirs in 11.
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
# 9: the model menu.  The magnetized-argon slice: B = 0.01 T on electrons
# (Omega = qB/m = 1.76e9 rad/s along -z), isotropic ionisation children, a
# periodic box, a thermal start at 2e6 m/s and the argon-like table at a
# gas density of 1e23 m^-3 and the mobility step of 1e-12 s
MAGNETIZED_ARGON = dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                        collision_model="isotropic", boundary="periodic",
                        init_vth=2.0e6)
ARGON = dict(gas_density=1e23, dt=1e-12)
SLICE = dict(MAIN, capacity=4_000_000, **MAGNETIZED_ARGON)
# (a): each model alone and all together at the const churn; the field is
# a strong one, so the rotation moves every velocity's bits
MODEL_CASES = {
    "boris": dict(integrator="boris"),
    "boris_field": dict(integrator="boris", b_field=(3e11, -5e11, 7e11)),
    "periodic": dict(boundary="periodic"),
    "isotropic": dict(collision_model="isotropic"),
    "thermal": dict(init_vth=2.0e6),
    "all": MAGNETIZED_ARGON,
}
# a step of 1e-9 s at 1e6 m/s moves 0.1 cell of a 16^3 box: lanes wrap
WRAP = dict(CHURN, grid_size=(16, 16, 16), mobility_dt=1e-9, init_vth=1e6,
            boundary="periodic")
# the kernels and their plain versions run the same float32 arithmetic
# (the same libdevice cos and sin in double precision, correctly rounded
# sqrtf): the bound on a float's difference is 0 ulps
MODEL_ULPS = 0
# (c): the FFT field on the card (cuFFT) against the CPU's, relative to
# the field's largest magnitude: the two FFT libraries round differently
# (5.3e-7 against XLA:CPU at 32^3, tests/test_torch_poisson_fft.py)
FFT_CARD_RTOL = 2e-5
# operations a lane-step of the general path adds to OPS_PER_PUSH under the
# slice's models (csrc/physics.cuh, an FMA as two): the boris rotation
# (54: the fused and the rounded v - h per axis, 9; per output axis two
# v' terms of 4 and the final cross term, add and subtract, 5: 39; the
# drift, 6) in place of the leapfrog's 18, +36; the periodic wrap (fmodf,
# the sign fix, the clamp and nextafterf, 7 an axis) in place of the
# bounds test's 6 compares, +15; and an isotropic child's velocity (the
# two uniforms, cos_t, sin_t, phi, the speed, cos, sin, three products),
# 22 a child
OPS_PER_PUSH_MODELS = OPS_PER_PUSH + 36 + 15
OPS_PER_ISOTROPIC_CHILD = 22
# 10: the sharded path at the main path's width, 4 Poisson steps; the phase
# bounds its own wall time
SHARDED_STEPS = 4
SHARDED_BUDGET_S = 120.0
MESH_ARGV = ["30", "0", "1000000", "2", "256", "2000000", "0", "100",
             "grid=256"]
# 11: the float64 oracle mode.  (a) tests/test_oracle.py's two
# configurations (the const table with the first, the sine table with the
# second); (b) the main path at capacity 4M (the naive cadence keeps a
# step's dead rows, as in 8a), 2 Poisson steps; (c) the const churn of 4a
# on the naive cadence, whose container holds a phase's appends (about
# 720k rows): 1M; (d) the CLI at a size the CPU tests run
ORACLE_CONST = dict(init_n=200, capacity=20_000, poisson_steps=3,
                    poisson_timestep=6, grid_size=(32, 32, 32))
ORACLE_SINE = dict(init_n=100, capacity=1000, poisson_steps=2,
                   poisson_timestep=8, grid_size=(32, 32, 32))
F64_MAIN = dict(MAIN, capacity=4_000_000, poisson_steps=2)
F64_CHURN = dict(CHURN, capacity=1 << 20, poisson_steps=2, scheduler="naive")
F64_CLI_ARGV = ["0", "2000", "2", "256", "65536", "0", "6", "grid=32"]
F64_BUDGET_S = 150.0


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


def models_on_card(dev, repo: str) -> dict:
    """Phase 9 (the module docstring): the model menu on the card.  Returns
    the keys the two engines' kernel lines gain."""
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from particle_simulation_tpu_torch import SimConfig, cross_section
    from particle_simulation_tpu_torch.ops.kernels.push_mcc import (
        mobility_phase_dynamic, mobility_phase_dynamic_plain, model_bits,
        staged_phase,
    )
    from particle_simulation_tpu_torch.ops.kernels.worklog import (
        mobility_phase_worklog, mobility_phase_worklog_plain, worklog_phase,
    )
    from particle_simulation_tpu_torch.ops.step import grid_phase, poisson_step
    from particle_simulation_tpu_torch.probes.common import (
        bound_ms, bound_terms,
    )
    from particle_simulation_tpu_torch.runtime import multiset_with_ids
    from particle_simulation_tpu_torch.state import setup_particles

    t_phase = time.perf_counter()

    def by_ids(state):
        m = multiset_with_ids(state)
        return m[np.lexsort((m[:, 11], m[:, 10], m[:, 9]))]

    def same(tag, a, ai, b, bi):
        """Two phases' outputs: ids, statuses and counters exact; the
        float fields to MODEL_ULPS.  Returns (lanes that differ, max
        ulps)."""
        keys = ("added", "removed", "overflow", "pushes_lo", "pushes_hi")
        check(a.n == b.n and {k: ai[k] for k in keys}
              == {k: bi[k] for k in keys},
              f"{tag}: n {a.n} vs {b.n}, counters {ai} vs {bi}")
        check(not ai["overflow"], f"{tag}: overflow")
        x, y = by_ids(a), by_ids(b)
        check(np.array_equal(x[:, 9:], y[:, 9:]),
              f"{tag}: ids or statuses differ")
        ulps = np.abs(x[:, :9].astype(np.int64) - y[:, :9].astype(np.int64))
        lanes, most = int((ulps > 0).any(1).sum()), int(ulps.max(initial=0))
        check(most <= MODEL_ULPS,
              f"{tag}: {lanes} lanes differ, by up to {most} ulps")
        return lanes, most

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop)

    engines = (("worklog", mobility_phase_worklog,
                mobility_phase_worklog_plain, worklog_phase),
               ("staged", mobility_phase_dynamic,
                mobility_phase_dynamic_plain, staged_phase))
    const = cross_section.load_table(cross_section.bundled_paths()[1], dev)

    # ---- 9a. each model, each engine against its plain version ----
    t0 = time.perf_counter()
    cases = [(name, dict(CHURN, **knobs)) for name, knobs in
             MODEL_CASES.items()] + [("wrap", WRAP)]
    for name, kw in cases:
        for depth in (2, 1):
            cfg = SimConfig(**kw, spawn_depth=depth)
            # the thermal start alone changes the seed state, not the path
            check(model_bits(cfg) != 0 or name == "thermal",
                  f"9a {name}: the reference model")
            st = setup_particles(cfg, device=dev)
            for s in range(2):
                g = grid_phase(st, cfg)
                outs = {}
                line = f"  9a {name} d{depth} step {s}:"
                for label, kernel, plain, _ in engines:
                    k = kernel(g, s, const, cfg, cfg.poisson_timestep)
                    p = plain(g, s, const, cfg, cfg.poisson_timestep)
                    lanes, most = same(f"9a {name} d{depth} step {s} "
                                       f"{label}", *k, *p)
                    outs[label] = k
                    line += (f" {label} equal to plain ({lanes} lanes "
                             f"differ, max {most} ulps);")
                same(f"9a {name} d{depth} step {s} engines",
                     *outs["worklog"], *outs["staged"])
                m = outs["worklog"][1]
                log(f"{line} engines equal; n={outs['worklog'][0].n} "
                    f"added={m['added']} removed={m['removed']}")
                st = outs["worklog"][0]
    # the wrap count: with no collisions, an absorbing box loses the lanes
    # that cross a face in the phase; the periodic one keeps them, wrapped
    zero = torch.zeros_like(const)
    cfg = SimConfig(**WRAP)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    kept = mobility_phase_worklog(st, 0, zero, cfg, cfg.poisson_timestep)
    lost = mobility_phase_worklog(st, 0, zero, cfg.replace(
        boundary="absorb"), cfg.poisson_timestep)
    wrapped = lost[1]["removed"]
    check(kept[1]["removed"] == 0 and wrapped > 0,
          f"9a wrap: {wrapped} lanes crossed a face, "
          f"{kept[1]['removed']} lost in the periodic box")
    pos = kept[0].pos[: kept[0].n]
    check(bool(((pos >= 0) & (pos < cfg.sim_size[0])).all()),
          "9a wrap: a position outside the periodic box")
    log(f"9a: every model alone and together, both engines equal to their "
        f"plain versions and to each other (ids, statuses, counters exact; "
        f"floats within {MODEL_ULPS} ulps), spawn_depth 2 and 1; wrap case "
        f"(16^3, dt 1e-9, init_vth 1e6): {wrapped} of {cfg.init_n} lanes "
        f"wrapped in the phase; {time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="pst_models_")
    argon_path = os.path.join(tmp, "argon.txt")
    cross_section.write_table(argon_path,
                              cross_section.argon_like_table(**ARGON))
    argon = cross_section.load_table(argon_path, dev)
    result = {}
    try:
        # ---- 9b. the magnetized-argon slice on both engines ----
        t0 = time.perf_counter()
        cfg = SimConfig(**SLICE, cross_section_path=argon_path)
        old_cfg = cfg.replace(scheduler="dynamic_old")
        st = setup_particles(cfg, device=dev)
        for _, _, _, wrapper in engines:
            wrapper.launches = 0
            wrapper.passes = 0
        phase_ms = {"worklog": [], "staged": []}
        step_ms, work, n_after = [], [], []
        for s in range(4):
            n_in = st.n
            recorded = {}

            def recording(label, fn):
                def phase(*args):
                    out, ms = timed(fn, *args)
                    recorded[label] = ms
                    return out
                phase.self_compacting = True
                return phase

            a, ms = timed(poisson_step, st, s, argon, cfg,
                          recording("worklog", mobility_phase_worklog))
            b = poisson_step(st, s, argon, old_cfg,
                             recording("staged", mobility_phase_dynamic))
            check(a[1] == b[1], f"9b step {s}: engines' metrics {a[1]} vs "
                  f"{b[1]}")
            check(np.array_equal(multiset_with_ids(a[0]),
                                 multiset_with_ids(b[0])),
                  f"9b step {s}: the engines' multisets differ")
            m = a[1]
            line = (f"  9b step {s}: n={m['n']} added={m['added']} "
                    f"removed={m['removed']} (growth "
                    f"{100 * (m['n'] - n_in) / n_in:+.1f}%), engines equal; "
                    f"worklog phase {recorded['worklog']:.3f} ms (passes "
                    f"{worklog_phase.last.get('passes')}), staged phase "
                    f"{recorded['staged']:.3f} ms (passes "
                    f"{staged_phase.last.get('passes')}), Poisson step "
                    f"{ms:.3f} ms")
            if s < 2:
                for label, _, plain, _ in engines:
                    c = cfg if label == "worklog" else old_cfg
                    p = poisson_step(st, s, argon, c, plain)
                    same(f"9b step {s} {label} vs plain", *a, *p)
                line += "; both equal to plain"
            log(line)
            if s:
                step_ms.append(ms)
                for label in phase_ms:
                    phase_ms[label].append(recorded[label])
                pushes = m["pushes_lo"] + (m["pushes_hi"] << 30)
                work.append((RECORD_BYTES * (n_in + m["n"])
                             + cross_section.N_STEPS * 8,
                             OPS_PER_PUSH_MODELS * pushes
                             + OPS_PER_ISOTROPIC_CHILD * m["added"]))
            n_after.append(m["n"])
            st = a[0]
        launches = {label: w.launches for label, _, _, w in engines}
        passes = {label: w.passes for label, _, _, w in engines}
        check(all(v == 4 for v in launches.values()),
              f"9b: launches {launches} in 4 phases of each engine")
        live = torch.cat([st.pos[: st.n], st.vel[: st.n], st.acc[: st.n]], 1)
        check(bool(torch.isfinite(live).all()), "9b: non-finite state")
        check(bool(((st.pos[: st.n] >= 0)
                    & (st.pos[: st.n] < cfg.sim_size[0])).all()),
              "9b: a position outside the periodic box")
        n_bytes, n_ops = (sum(w[i] for w in work) / len(work) for i in (0, 1))
        by_bytes, by_ops = bound_terms(n_bytes, n_ops)
        bound, by = bound_ms(n_bytes, n_ops)
        log(f"bound of a slice phase: {n_bytes:.6g} B -> {by_bytes:.4f} ms, "
            f"{n_ops:.6g} operations -> {by_ops:.4f} ms; {by} set it")

        def stats(xs):
            return sum(xs) / len(xs), sorted(xs)[len(xs) // 2]

        for label in phase_ms:
            mean, median = stats(phase_ms[label])
            result[label] = {"models_ms": mean, "models_ms_median": median,
                             "models_launches": launches[label],
                             "models_passes": passes[label],
                             "models_bound_ms": bound}
        mean, median = stats(step_ms)
        log(f"9b: magnetized argon ({cfg.init_n} electrons, capacity "
            f"{cfg.capacity}, {cfg.grid_size[0]}^3, T={cfg.poisson_timestep}"
            f", boris b_field={cfg.b_field} rad/s, isotropic, periodic, "
            f"init_vth {cfg.init_vth:g}, argon-like table {ARGON}): n by "
            f"step {n_after}; "
            f"launches {launches}, device-counted passes {passes}; steps 1-3 "
            f"worklog phase mean {result['worklog']['models_ms']:.3f} ms "
            f"(median {result['worklog']['models_ms_median']:.3f}), staged "
            f"phase mean {result['staged']['models_ms']:.3f} ms (median "
            f"{result['staged']['models_ms_median']:.3f}), Poisson step "
            f"(dynamic) mean {mean:.3f} ms (median {median:.3f}); the "
            f"engines equal every step, each equal to plain at steps 0-1; "
            f"{time.perf_counter() - t0:.1f} s")
        del st, a, b

        # ---- 9c. the slice with the FFT field on dynamic ----
        t0 = time.perf_counter()
        cfg = SimConfig(**SLICE, cross_section_path=argon_path,
                        field_model="fft")
        st = setup_particles(cfg, device=dev)
        worklog_phase.launches = 0
        for s in range(2):
            acc = grid_phase(st, cfg).acc
            cpu = st._replace(**{f: getattr(st, f).cpu() for f in
                                 ("pos", "vel", "acc", "status", "id_hi",
                                  "id_lo")})
            want = grid_phase(cpu, cfg).acc.double()
            rel = float((acc.cpu().double() - want).abs().max()
                        / want.abs().max())
            check(rel <= FFT_CARD_RTOL,
                  f"9c step {s}: the card's FFT field is {rel:.3g} of the "
                  f"largest magnitude off the CPU's")
            st, m = poisson_step(st, s, argon, cfg)
            log(f"  9c step {s}: FFT field within {rel:.3g} of the CPU's "
                f"(bound {FFT_CARD_RTOL:g}); n={m['n']} added={m['added']} "
                f"removed={m['removed']}")
        check(worklog_phase.launches == 2,
              f"9c: {worklog_phase.launches} work-log launches in 2 phases")
        check(bool(torch.isfinite(st.acc[: st.n]).all()), "9c: non-finite")
        log(f"9c: the slice with field_model=fft on dynamic, 2 steps; "
            f"{time.perf_counter() - t0:.1f} s")
        del st, acc, cpu, want

        # ---- 9d. the CLI with the model knobs ----
        t0 = time.perf_counter()
        argv = ["30", "0", "1000000", "2", "256", "4000000", "0", "100",
                "grid=256", f"cs={argon_path}", "integrator=boris",
                "bfield=0,0,-1.76e9", "collision_model=isotropic",
                "boundary=periodic", "init_vth=2e6"]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, env.get("PYTHONPATH")) if p)
        res = subprocess.run(
            [sys.executable, "-m", "particle_simulation_tpu_torch", *argv],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        for line in res.stdout.splitlines()[-4:]:
            log(f"  9d | {line}")
        check(res.returncode == 0,
              f"9d: exited {res.returncode}: {res.stderr[-2000:]}")
        final = [line for line in res.stdout.splitlines()
                 if line.startswith("Final amount of particles:")]
        check(final == [f"Final amount of particles: {n_after[1]}"],
              f"9d: {final} vs the slice's n {n_after[1]} after 2 steps")
        log(f"9d: python -m particle_simulation_tpu_torch {' '.join(argv)}:"
            f" exit 0, final n {n_after[1]} equal to 9b's; "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log(f"9: the model menu done in {time.perf_counter() - t_phase:.1f} s")
    return result


def live_rows(arrays):
    """Gathered live rows (numpy, the JAX SimState's types) as the int32
    rows of ``runtime.multiset_with_ids``, in lexicographic order."""
    import numpy as np

    cols = [arrays["pos"].view(np.int32), arrays["vel"].view(np.int32),
            arrays["acc"].view(np.int32), arrays["status"][:, None],
            arrays["id_hi"].view(np.int32)[:, None],
            arrays["id_lo"].view(np.int32)[:, None]]
    rows = np.concatenate(cols, axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def mps_status() -> str:
    """Whether an MPS server runs on the card (nvidia-smi's compute apps)
    and the card's compute mode."""
    import subprocess

    def query(*args):
        return subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()

    apps = query("--query-compute-apps=pid,process_name")
    mps = any("mps" in line.lower() for line in apps.splitlines())
    return (f"MPS {'active' if mps else 'not active'} (compute apps: "
            f"{apps.splitlines() or 'none'}), compute mode "
            f"{query('--query-gpu=compute_mode')}")


def sharded_on_card(dev, repo: str) -> dict:
    """Phase 10 (the module docstring): the sharded path on the card, its
    wall time bounded by SHARDED_BUDGET_S.  Returns each kernel's launches
    in the ranks."""
    import subprocess

    import numpy as np
    import torch

    from particle_simulation_tpu_torch import SimConfig, cross_section
    from particle_simulation_tpu_torch.ops.step import poisson_loop
    from particle_simulation_tpu_torch.parallel import launch, sharded
    from particle_simulation_tpu_torch.runtime import multiset_with_ids
    from particle_simulation_tpu_torch.state import setup_particles

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    sine = cross_section.load_table(cross_section.bundled_paths()[0], dev)

    def left() -> float:
        s = SHARDED_BUDGET_S - (time.perf_counter() - t_phase)
        check(s > 0, f"10: over its {SHARDED_BUDGET_S} s bound")
        return s

    total = {"worklog_phase": 0, "staged_phase": 0, "packed_field_gather": 0}

    def ranks(tag, n, scenarios, **kw):
        t0 = time.perf_counter()
        res = launch.run(sharded.run_scenarios, n, args=(scenarios,),
                         timeout_s=left(), **kw)
        for r in res:
            check(not r[0]["foreign_modules"],
                  f"10{tag}: a rank imported {r[0]['foreign_modules']}")
            for sc in r:
                for k, v in sc["launches"].items():
                    total[k] += v
        log(f"10{tag}: {n} rank(s), {res[0][0]['backend']} on "
            f"{[r[0]['device'] for r in res]}, {len(scenarios)} scenarios "
            f"in {time.perf_counter() - t0:.1f} s")
        return res

    # the single-process reference: poisson_loop on the main path
    base_cfg = SimConfig(**MAIN, poisson_steps=SHARDED_STEPS)
    st, m = poisson_loop(setup_particles(base_cfg, device=dev),
                         sine, base_cfg, SHARDED_STEPS)
    want_rows = multiset_with_ids(st)
    want_hist = [{"n": m["n"][i], "added": m["added"][i],
                  "removed": m["removed"][i],
                  "overflow": int(m["overflow"][i]),
                  "pushes": m["pushes_lo"][i] + (m["pushes_hi"][i] << 30)}
                 for i in range(SHARDED_STEPS)]
    check(all(h["overflow"] == 0 for h in want_hist), "10: overflow")
    log(f"10: single-process poisson_loop, {SHARDED_STEPS} steps, final "
        f"n={st.n}; {time.perf_counter() - t_phase:.1f} s")
    del st

    def same(tag, sc):
        check(sc["history"] == want_hist,
              f"10{tag}: history {sc['history']} vs {want_hist}")
        check(np.array_equal(live_rows(sc["live"]), want_rows),
              f"10{tag}: the live multiset with ids differs")

    def launched(tag, rank_results, i, needed):
        for name in needed:
            got = [r[i]["launches"][name] for r in rank_results]
            check(all(g > 0 for g in got),
                  f"10{tag}: {name} launched {got} times in the ranks")

    # ---- 10a. NCCL, world size 1, full width ----
    slab_cfg = base_cfg.replace(grid_mode="slab")
    scs = [{"config": base_cfg}, {"config": slab_cfg},
           {"config": base_cfg, "timed": True, "gather": False},
           {"config": slab_cfg, "timed": True, "gather": False}]
    res = ranks("a", 1, scs, device=dev)
    r0 = res[0]
    for i, tag in enumerate(("a replicated", "a slab")):
        same(tag, r0[i])
        launched(tag, res, i, ["worklog_phase"])
        ms = r0[i]["step_ms"]
        log(f"10{tag}: equal to poisson_loop (multiset with ids, "
            f"counters); ms a step {[round(x, 3) for x in ms]} (steps 1-"
            f"{len(ms) - 1} mean {np.mean(ms[1:]):.3f}); paths "
            f"{r0[i]['field_paths']}; launches {r0[i]['launches']}")
    launched("a replicated", res, 0, ["packed_field_gather"])
    check(r0[1]["field_paths"]["slab"] > 0,
          f"10a slab: paths {r0[1]['field_paths']}")
    comm = {}
    for i, tag in ((2, "replicated"), (3, "slab")):
        steps = len(r0[i]["history"])
        comm[tag] = {k: [c / steps, b / steps, ms / steps]
                     for k, (c, b, ms) in r0[i]["comm"].items()}
        log(f"10a {tag}, collectives timed (synchronised): ms a step "
            f"{[round(x, 3) for x in r0[i]['step_ms']]}; per step "
            + "; ".join(f"{k}: {c:g} calls, {b:.0f} B, {ms:.4f} ms"
                        for k, (c, b, ms) in comm[tag].items()))
    step_ms = float(np.mean(r0[0]["step_ms"][1:]))
    charge = comm["replicated"]["charge"]

    # ---- 10b. two ranks sharing the card over gloo ----
    log(f"10b: {mps_status()}")
    half = base_cfg.replace(init_n=base_cfg.init_n // 2,
                            capacity=base_cfg.capacity // 2)
    scs = [{"config": half}, {"config": half.replace(grid_mode="slab")},
           {"config": half.replace(scheduler="dynamic_old")}]
    res = ranks("b", 2, scs, device=dev, backend="gloo")
    for i, tag in enumerate(("b replicated", "b slab",
                             "b replicated dynamic_old")):
        same(tag, res[0][i])
        needed = ["staged_phase" if i == 2 else "worklog_phase"]
        launched(tag, res, i, needed + (["packed_field_gather"]
                                        if i != 1 else []))
        log(f"10{tag}: equal to 10a (multiset with ids, counters); ms a "
            f"step rank 0 {[round(x, 2) for x in res[0][i]['step_ms']]}; "
            f"launches {[r[i]['launches'] for r in res]}; host-staged "
            f"{res[0][i]['host_staged']}, {res[0][i]['host_copies']} host "
            f"copies on rank 0")
    check(res[0][1]["field_paths"]["slab"] > 0,
          f"10b slab: paths {res[0][1]['field_paths']}")

    # ---- 10c. NCCL across cards ----
    cards = torch.cuda.device_count()
    if cards >= 2:
        res = ranks("c", 2, [{"config": half}], device=dev)
        same("c", res[0][0])
        launched("c", res, 0, ["worklog_phase", "packed_field_gather"])
        log(f"10c: NCCL over 2 cards equal to 10a; ms a step rank 0 "
            f"{[round(x, 2) for x in res[0][0]['step_ms']]}")
    else:
        log(f"10c: not run: NCCL across cards needs 2, this machine has "
            f"{cards}")

    # ---- 10d. the CLI with mesh=1 ----
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    argv = [*MESH_ARGV, "mesh=1"]
    proc = subprocess.run(
        [sys.executable, "-m", "particle_simulation_tpu_torch", *argv],
        cwd=repo, env=env, capture_output=True, text=True, timeout=left())
    for line in proc.stdout.splitlines():
        log(f"  10d | {line}")
    check(proc.returncode == 0,
          f"10d: exit {proc.returncode}: {proc.stderr[-2000:]}")
    final = [line for line in proc.stdout.splitlines()
             if line.startswith("Final amount of particles: ")]
    n_cli = int(final[-1].split(": ")[1])
    steps = int(MESH_ARGV[3])
    check(n_cli == want_hist[steps - 1]["n"],
          f"10d: final n {n_cli} vs 10a's {want_hist[steps - 1]['n']} "
          f"after {steps} steps")
    log(f"10d: python -m particle_simulation_tpu_torch {' '.join(argv)}: "
        f"exit 0, final n {n_cli} equal to 10a's after {steps} steps; "
        f"{time.perf_counter() - t0:.1f} s")
    left()
    log(f"10: the sharded path done in {time.perf_counter() - t_phase:.1f} "
        f"s (bound {SHARDED_BUDGET_S} s); launches in the ranks {total}")
    return {"launches": total, "step_ms": step_ms, "charge": charge,
            "comm": comm}


def f64_on_card(dev, repo: str) -> dict:
    """Phase 11 (the module docstring): the float64 oracle mode, the
    checkpoints and the CLI in it, and the weak-scaling probe, the wall
    time bounded by F64_BUDGET_S.  Returns the kernels' launches in the
    phase (11a's and 11b's float32 ``dynamic`` runs, 11e's rank) and the
    numbers PERF.md reports."""
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from particle_simulation_tpu_torch import SimConfig, checkpoint
    from particle_simulation_tpu_torch import cross_section
    from particle_simulation_tpu_torch.ops import grid as grid_ops
    from particle_simulation_tpu_torch.parallel.sharded import kernel_counters
    from particle_simulation_tpu_torch.probes import weak_scaling
    from particle_simulation_tpu_torch.runtime import multiset_with_ids, run_pic

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kernels = kernel_counters()
    total = dict.fromkeys(kernels, 0)
    const = cross_section.bundled_paths()[1]
    out = {}

    def left() -> float:
        s = F64_BUDGET_S - (time.perf_counter() - t_phase)
        check(s > 0, f"11: over its {F64_BUDGET_S} s bound")
        return s

    def counted(tag, cfg, need=(), device=dev):
        """run_pic of ``cfg`` with the launch counts at 0 before it; every
        kernel in ``need`` must launch, and a float64 run none (its field
        phase must take the float64 gather at every step)."""
        for k in kernels.values():
            k.launches = 0
        grid_ops.field_counts.reset()
        run = run_pic(cfg, print_header=False, device=device)
        got = {name: k.launches for name, k in kernels.items()}
        for name in need:
            check(got[name] > 0, f"11{tag}: {name} launched {got[name]} "
                  "times")
        if cfg.precision == "f64":
            check(not any(got.values()), f"11{tag}: f64 launched {got}")
            check(run.state.pos.dtype == torch.float64,
                  f"11{tag}: positions {run.state.pos.dtype}")
            paths = grid_ops.field_counts.paths
            check(paths["f64"] == len(run.steps) == sum(paths.values()),
                  f"11{tag}: field paths {paths}")
        for name, v in got.items():
            total[name] += v
        return run

    def ids(state):
        n = state.n_clamped
        words = torch.stack([state.id_hi[:n], state.id_lo[:n]], 1).cpu()
        rows = words.numpy()
        return rows[np.lexsort(rows.T[::-1])]

    def counters(run):
        return [(s.n, s.added, s.removed, s.overflow, s.pushes)
                for s in run.steps]

    # ---- 11a. tests/test_oracle.py's invariants on the card ----
    cfg = SimConfig(**ORACLE_CONST, cross_section_path=const)
    r64 = counted("a const f64 sync", cfg.replace(scheduler="sync",
                                                  precision="f64"))
    for sched, need in (("dynamic", ("worklog_phase",)), ("sync", ())):
        r32 = counted(f"a const f32 {sched}", cfg.replace(scheduler=sched),
                      need)
        check([(s.n, s.added) for s in r32.steps]
              == [(s.n, s.added) for s in r64.steps],
              f"11a const: f32 {sched} {counters(r32)} vs f64 "
              f"{counters(r64)}")
        check(np.array_equal(ids(r32.state), ids(r64.state)),
              f"11a const: the id multisets of f32 {sched} and f64 differ")
    check(sum(s.added for s in r64.steps) > 0, "11a const: no split")
    log(f"11a const table: f32 dynamic (the kernel) and f32 sync equal to "
        f"f64 sync on n, added and the id multiset; n "
        f"{[s.n for s in r64.steps]}, added {[s.added for s in r64.steps]}")
    cfg = SimConfig(**ORACLE_SINE, scheduler="sync")
    r32 = counted("a sine f32", cfg)
    r64 = counted("a sine f64", cfg.replace(precision="f64"))
    n = r32.final_n
    check(n == r64.final_n > 0, f"11a sine: n {n} vs {r64.final_n}")
    rel = {}
    for f, rtol, atol in (("vel", 2e-5, 1e-12), ("pos", 1e-5, 0.0)):
        a = getattr(r32.state, f)[:n].double().cpu().numpy()
        b = getattr(r64.state, f)[:n].cpu().numpy()
        check(np.allclose(a, b, rtol=rtol, atol=atol),
              f"11a sine: {f} outside rtol {rtol}")
        rel[f] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    log(f"11a sine table: n {n} equal; f32 against f64 largest relative "
        f"difference vel {rel['vel']:.3e} (rtol 2e-5), pos "
        f"{rel['pos']:.3e} (rtol 1e-5)")
    left()

    # ---- 11b. f64 at the main path's size ----
    t0 = time.perf_counter()
    cfg = SimConfig(**F64_MAIN, precision="f64")
    runs = {}
    for sched in ("sync", "naive"):
        runs[sched] = r = counted(f"b {sched}", cfg.replace(scheduler=sched))
        ms = [s.wall_s * 1e3 for s in r.steps]
        out[f"f64_{sched}_ms"] = ms
        log(f"11b f64 {sched}: ms a step {[round(x, 1) for x in ms]} "
            f"(mean {np.mean(ms):.1f}); n {[s.n for s in r.steps]}")
        left()
    check(counters(runs["sync"]) == counters(runs["naive"]),
          f"11b: sync {counters(runs['sync'])} vs naive "
          f"{counters(runs['naive'])}")
    check(np.array_equal(multiset_with_ids(runs["sync"].state),
                         multiset_with_ids(runs["naive"].state)),
          "11b: the f64 sync and naive multisets differ")
    n64 = runs["sync"].final_n
    del runs
    r32 = counted("b f32 dynamic", cfg.replace(precision="f32",
                                               scheduler="dynamic"),
                  ("worklog_phase", "packed_field_gather"))
    out["f64_final_n"], out["f32_final_n"] = n64, r32.final_n
    log(f"11b: f64 sync equal to f64 naive (multiset with ids, counters); "
        f"final n f64 {n64}, f32 dynamic {r32.final_n}, relative "
        f"difference {(r32.final_n - n64) / n64:+.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    del r32
    left()

    # ---- 11c. the card against the CPU in f64 ----
    t0 = time.perf_counter()
    cfg = SimConfig(**F64_CHURN, cross_section_path=const, precision="f64")
    card = counted("c card", cfg)
    cpu = run_pic(cfg, print_header=False, device="cpu")
    check(counters(card) == counters(cpu),
          f"11c: card {counters(card)} vs CPU {counters(cpu)}")
    check(np.array_equal(multiset_with_ids(card.state),
                         multiset_with_ids(cpu.state)),
          "11c: the card's f64 multiset differs from the CPU's")
    log(f"11c: f64 naive at the const churn, card equal to CPU bit for bit "
        f"(multiset with ids, counters {counters(card)}); "
        f"{time.perf_counter() - t0:.1f} s")
    left()

    # ---- 11d. float64 checkpoints, the CLI ----
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    cli = [sys.executable, "-m", "particle_simulation_tpu_torch"]
    procs = {mode: subprocess.Popen(
        [*cli, mode, *F64_CLI_ARGV, f"cs={const}", "precision=f64"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for mode in ("31", "30")}
    cfg = SimConfig(**ORACLE_CONST, cross_section_path=const,
                    scheduler="sync", precision="f64", verbose=1)
    with tempfile.TemporaryDirectory() as d:
        full = run_pic(cfg, print_header=False, device=dev,
                       on_step=checkpoint.make_checkpoint_hook(cfg, d))
        for t in range(2, cfg.poisson_steps + 1):
            os.remove(os.path.join(d, f"step_{t:06d}.npz"))
        resumed = checkpoint.resume_run(cfg, d, device=dev)
        check([s.n for s in resumed.steps] == [s.n for s in full.steps[1:]],
              "11d: the resumed steps differ")
        check(np.array_equal(multiset_with_ids(resumed.state),
                             multiset_with_ids(full.state)),
              "11d: the resumed f64 run differs from the uninterrupted one")
        path = os.path.join(d, "step_000001.npz")
        st32, _ = checkpoint.load_npz(path, dev)
        with np.load(path) as z:
            check(z["pos"].dtype == np.float64, "11d: not a float64 file")
            for f in ("pos", "vel"):
                check(np.array_equal(getattr(st32, f).cpu().numpy(),
                                     z[f].astype(np.float32)),
                      f"11d: {f} not converted by value under f32")
    log("11d: a float64 checkpoint resumes equal to the uninterrupted f64 "
        "run (multiset with ids); under f32 it loads rounded by value")
    res = {m: p.communicate(timeout=left()) for m, p in procs.items()}
    for line in res["31"][0].splitlines():
        log(f"  11d 31 | {line}")
    check(procs["31"].returncode == 0,
          f"11d: mode 31 precision=f64 exit {procs['31'].returncode}: "
          f"{res['31'][1][-2000:]}")
    want = "the fused work-log engine is f32-only; use scheduler='sync'"
    check(procs["30"].returncode != 0 and want in res["30"][1],
          f"11d: mode 30 precision=f64 exit {procs['30'].returncode}: "
          f"{res['30'][1][-500:]}")
    log(f"11d: mode 31 precision=f64 exit 0; mode 30 precision=f64 exit "
        f"{procs['30'].returncode}: {res['30'][1].strip().splitlines()[-1]}"
        f"; {time.perf_counter() - t0:.1f} s")
    left()

    # ---- 11e. the weak-scaling probe ----
    t0 = time.perf_counter()
    rows = weak_scaling.sweep(max_ranks=4, device=dev, timeout_s=left())
    cards = torch.cuda.device_count()
    check(len(rows) == min(cards, 4).bit_length(),
          f"11e: {len(rows)} rows on {cards} cards")
    for r in rows:
        check(r["launches"]["worklog_phase"] > 0,
              f"11e: worklog_phase launched {r['launches']} in rank 0")
        check(r["final_n"] > 0 and r["charge_bytes_step"]
              == 4 * 256 ** 3, f"11e: row {r}")
        total["worklog_phase"] += r["launches"]["worklog_phase"]
        total["packed_field_gather"] += r["launches"]["packed_field_gather"]
    out["weak_scaling"] = [{k: v for k, v in r.items() if k != "comm"}
                           for r in rows]
    log(f"11e: {len(rows)} row(s) in {time.perf_counter() - t0:.1f} s")
    left()
    log(f"11: the f64 oracle, its checkpoints and CLI, the weak-scaling "
        f"probe done in {time.perf_counter() - t_phase:.1f} s (bound "
        f"{F64_BUDGET_S} s); launches {total}")
    out["launches"] = total
    return out


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
        ptxas,
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
    for line in ptxas.format_lines(lib.build_log):
        log(f"  ptxas: {line}")

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

    # ---- 9. the model menu ----
    models = models_on_card(dev, os.path.dirname(os.path.abspath(__file__)))

    # ---- 10. the sharded path ----
    shard = sharded_on_card(dev, os.path.dirname(os.path.abspath(__file__)))
    shard_launches = shard["launches"]

    # ---- 11. the f64 oracle mode, its checkpoints, the weak-scaling probe
    oracle = f64_on_card(dev, os.path.dirname(os.path.abspath(__file__)))

    log(card())  # again here, so the end of the output names the card
    log(json.dumps({"kernels": [{
        "name": "worklog_phase",
        "route": "cuda",
        "source": "particle_simulation_tpu_torch/csrc/worklog.cu",
        "replaces": "particle_simulation_tpu/ops/pallas/worklog.py:302",
        "launches": launches_worklog,
        "launches_entry_points": entry["worklog_phase"],
        "launches_sharded": shard_launches["worklog_phase"],
        "launches_phase11": oracle["launches"]["worklog_phase"],
        "passes": passes_worklog,
        "device_busy_share": busy,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "ms_median": kernel_median,
        "plain_ms": plain_ms,
        "plain_ms_median": plain_median,
        **bounds("worklog_phase", *worklog_work),
        "library_ms": None,
        **models["worklog"],
    }, {
        "name": "staged_phase",
        "route": "cuda",
        "source": "particle_simulation_tpu_torch/csrc/staged.cu",
        "replaces": "particle_simulation_tpu/ops/pallas/push_mcc.py:1113",
        "launches": staged_launches,
        "launches_entry_points": entry["staged_phase"],
        "launches_sharded": shard_launches["staged_phase"],
        "launches_phase11": oracle["launches"]["staged_phase"],
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
        **models["staged"],
    }, {
        "name": "field_gather",
        "route": "cuda",
        "source": "particle_simulation_tpu_torch/csrc/field.cu",
        "replaces": "scripts/microbench_fieldgather.py:40",
        "launches": field_launches,
        "launches_entry_points": entry["field_gather"],
        "launches_sharded": shard_launches["packed_field_gather"],
        "launches_phase11": oracle["launches"]["packed_field_gather"],
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
