#!/usr/bin/env python3
"""Chip check of the PyTorch + CUDA port (particle_simulation_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Phases, each printing one line or a few:

1. require CUDA (there is no CPU path);
2. the card's name and power limit (nvidia-smi);
3. build the kernels (csrc/worklog.cu, csrc/staged.cu) and print the
   build time;
4. each kernel against its plain PyTorch version on the same inputs, each
   Poisson step: the sorted particle multiset with ids and the counters
   n, added, removed, overflow, pushes_lo, pushes_hi must be equal
   (tolerance: exact);
   (a) work-log: const 50/50 table, 65,536 particles, grid 64^3, T=20, 3
       steps, spawn_depth 2 and 1 (1 forces suspension);
   (b) work-log: the main path's configuration, its first 4 steps;
   (c) staged (scheduler dynamic_old): the configuration of (a), through
       ops.step.poisson_step;
   (d) staged: the main path's configuration with dynamic_old, its first 3
       steps, against the work-log kernel every step (the cadence
       invariant) and against its plain version on steps 0 and 1;
5. the main path: 1M electrons, capacity 2M, grid 256^3, T=100, the
   bundled sine table, scheduler dynamic, through ops.step.poisson_loop;
   1 warm and 3 timed Poisson steps, then the plain version likewise;
   (b) the same with scheduler dynamic_old (the staged kernel), then its
   plain version over 1 warm and 1 timed step.

Any failed check raises, so the script exits non-zero.  The last line is
the device record {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches on the main path and their times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

MAIN = dict(init_n=1_000_000, capacity=2_000_000, poisson_timestep=100,
            grid_size=(256, 256, 256), scheduler="dynamic")
# (a): the 50/50 table makes every draw split or absorb, so a step of T=20
# appends about 10x the live population (the BASELINE.md config-4 churn)
CHURN = dict(init_n=65_536, capacity=262_144, poisson_timestep=20,
             grid_size=(64, 64, 64), scheduler="dynamic")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from particle_simulation_tpu_torch import SimConfig, cross_section
    from particle_simulation_tpu_torch.ops.kernels import build
    from particle_simulation_tpu_torch.ops.kernels.push_mcc import (
        mobility_phase_dynamic, mobility_phase_dynamic_plain, staged_pass,
        staged_reclaim,
    )
    from particle_simulation_tpu_torch.ops.kernels.worklog import (
        mobility_phase_worklog, mobility_phase_worklog_plain, worklog_pass,
    )
    from particle_simulation_tpu_torch.ops.step import (
        grid_phase, poisson_loop, poisson_step,
    )
    from particle_simulation_tpu_torch.runtime import multiset_with_ids
    from particle_simulation_tpu_torch.state import setup_particles

    dev = torch.device("cuda", 0)

    # ---- 2. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
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

    def kernel_vs_plain(tag, cfg, table, steps):
        """Both phases on the same grid-phase output each step; returns the
        per-step phase times (ms) of the kernel and the plain version."""
        st = setup_particles(cfg, device=dev)
        k_ms, p_ms = [], []
        for s in range(steps):
            st = grid_phase(st, cfg)
            k_out, kt = timed(mobility_phase_worklog, st, s, table, cfg,
                              cfg.poisson_timestep)
            p_out, pt = timed(mobility_phase_worklog_plain, st, s, table, cfg,
                              cfg.poisson_timestep)
            c = compare(f"{tag} step {s}", k_out, p_out)
            log(f"  {tag} step {s}: equal, n={c['n']} added={c['added']} "
                f"removed={c['removed']} pushes="
                f"{c['pushes_lo'] + (c['pushes_hi'] << 30)} "
                f"kernel {kt:.2f} ms plain {pt:.2f} ms")
            k_ms.append(kt)
            p_ms.append(pt)
            st = k_out[0]
        return k_ms, p_ms

    # ---- 4. kernel vs plain ----
    for depth in (2, 1):
        cfg = SimConfig(**CHURN, spawn_depth=depth)
        kernel_vs_plain(f"4a const d{depth}", cfg, const, 3)
    log("4a: kernel equal to plain (const table, spawn_depth 2 and 1)")
    main_cfg = SimConfig(**MAIN)
    k_ms, p_ms = kernel_vs_plain("4b main", main_cfg, sine, 4)
    log("4b: kernel equal to plain (main-path config, 4 steps)")
    # phase times at the main path's shapes, first step as warm-up
    kernel_ms = sum(k_ms[1:]) / len(k_ms[1:])
    plain_ms = sum(p_ms[1:]) / len(p_ms[1:])

    # ---- 4c/4d. the staged kernel, through Poisson steps ----
    def timed_phase(fn, record):
        """``fn`` as a mobility phase that records (ms, info) per call."""
        def phase(*args):
            out, ms = timed(fn, *args)
            record.append((ms, out[1]))
            return out
        return phase

    def step_compare(tag, a, b):
        """Two Poisson steps from one state: multiset + ids + the six
        counters."""
        nonlocal staged_err
        (sa, ma), (sb, mb) = a, b
        staged_err = max(staged_err, multiset_err(tag, sa, sb))
        check(ma == mb, f"{tag}: counters {ma} vs {mb}")
        check(not ma["overflow"], f"{tag}: overflow")

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
            step_compare(f"4c const d{depth} step {s}", a, b)
            m = a[1]
            log(f"  4c const d{depth} step {s}: equal, n={m['n']} "
                f"added={m['added']} removed={m['removed']} "
                f"reclaimed={kr[0][1]['reclaimed']} "
                f"kernel {kr[0][0]:.2f} ms plain {pr[0][0]:.2f} ms")
            st = a[0]
    log("4c: staged kernel equal to plain (const table, spawn_depth 2 and 1)")

    old_cfg = SimConfig(**dict(MAIN, scheduler="dynamic_old"))
    st = setup_particles(old_cfg, device=dev)
    staged_ms = staged_plain_ms = None
    for s in range(3):
        kr, pr = [], []
        before = staged_pass.launches
        a = poisson_step(st, s, sine, old_cfg,
                         phase=timed_phase(mobility_phase_dynamic, kr))
        passes = staged_pass.launches - before
        step_compare(f"4d step {s} vs dynamic", a,
                     poisson_step(st, s, sine, main_cfg))
        m, (k_ms, info) = a[1], kr[0]
        line = (f"  4d main step {s}: equal to dynamic, n={m['n']} "
                f"added={m['added']} removed={m['removed']} passes={passes} "
                f"reclaimed={info['reclaimed']} kernel {k_ms:.2f} ms")
        if s < 2:
            step_compare(f"4d step {s} vs plain", a, poisson_step(
                st, s, sine, old_cfg,
                phase=timed_phase(mobility_phase_dynamic_plain, pr)))
            line += f", equal to plain {pr[0][0]:.2f} ms"
        if s == 1:  # where the MCC first adds ~1M children
            staged_ms, staged_plain_ms = k_ms, pr[0][0]
        log(line)
        st = a[0]
    log("4d: dynamic_old kernel equal to the dynamic kernel (3 steps) and to "
        "its plain version (steps 0-1), main-path config")

    # ---- 5. the main path ----
    def drive(cfg, phase, timed_steps=3):
        st = setup_particles(cfg, device=dev)
        st, warm = poisson_loop(st, sine, cfg, 1, phase=phase)
        (st, m), ms = timed(poisson_loop, st, sine, cfg, timed_steps, 1,
                            phase)
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
        return ms / timed_steps, pushes / (ms / 1e3), n, m

    worklog_pass.launches = 0
    step_ms, rate, n, m = drive(main_cfg, None)
    launches = worklog_pass.launches
    check(launches > 0, "the main path did not launch the work-log kernel")
    log(f"5 main path (kernel): {step_ms:.2f} ms/Poisson step, "
        f"{rate:.4e} pushes/s, final n={n}, overflow=False, "
        f"worklog_pass launches={launches}, added={m['added']} "
        f"removed={m['removed']}")
    plain_step_ms, plain_rate, plain_n, _ = drive(
        main_cfg, mobility_phase_worklog_plain)
    check(plain_n == n, f"plain final n {plain_n} vs kernel {n}")
    log(f"5 main path (plain): {plain_step_ms:.2f} ms/Poisson step, "
        f"{plain_rate:.4e} pushes/s, final n={plain_n}")
    log(f"mobility phase at the main path: kernel {kernel_ms:.2f} ms, "
        f"plain {plain_ms:.2f} ms per Poisson step")

    staged_pass.launches = 0
    staged_reclaim.calls = 0
    old_ms, old_rate, old_n, old_m = drive(old_cfg, None)
    staged_launches = staged_pass.launches
    check(staged_launches > 0, "the main path did not launch the staged kernel")
    check(old_n == n, f"dynamic_old final n {old_n} vs dynamic {n}")
    log(f"5b main path dynamic_old (kernel): {old_ms:.2f} ms/Poisson step, "
        f"{old_rate:.4e} pushes/s, final n={old_n}, overflow=False, "
        f"staged_pass launches={staged_launches}, "
        f"reclaims={staged_reclaim.calls}, added={old_m['added']} "
        f"removed={old_m['removed']}")
    old_plain_ms, old_plain_rate, old_plain_n, _ = drive(
        old_cfg, mobility_phase_dynamic_plain, timed_steps=1)
    log(f"5b main path dynamic_old (plain): {old_plain_ms:.2f} ms/Poisson "
        f"step over 1 step, {old_plain_rate:.4e} pushes/s, "
        f"final n={old_plain_n}")
    log(f"staged mobility phase at main-path step 1: kernel {staged_ms:.2f} "
        f"ms, plain {staged_plain_ms:.2f} ms")

    log(json.dumps({"kernels": [{
        "name": "worklog_pass",
        "route": "cuda",
        "source": "particle_simulation_tpu_torch/csrc/worklog.cu",
        "replaces": "particle_simulation_tpu/ops/pallas/worklog.py:302",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "staged_pass",
        "route": "cuda",
        "source": "particle_simulation_tpu_torch/csrc/staged.cu",
        "replaces": "particle_simulation_tpu/ops/pallas/push_mcc.py:1113",
        "launches": staged_launches,
        "max_abs_err": staged_err,
        "ms": staged_ms,
        "plain_ms": staged_plain_ms,
    }]}))
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
