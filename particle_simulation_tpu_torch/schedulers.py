"""Scheduler cadences (counterpart of
``particle_simulation_tpu/schedulers.py``).

* ``naive``: every live slot advances together, one pass per mobility
  step, children appended after each step (reference Naive,
  src/pic.cu:251-288);
* ``sync``: the generation fixed point, the parity oracle: the slots of a
  generation run through every step, then the children they appended,
  until no new particle appears (reference CPU Sync, src/pic.cu:214-248);
* ``dynamic``: the work-log engine, ops/kernels/worklog.py;
* ``dynamic_old``: the staged engine, ops/kernels/push_mcc.py, kept as the
  reference keeps its older persistent kernel as mode 33
  (src/pic.cu:291-316).

The fused engines run their CUDA kernels on CUDA tensors and their plain
versions on CPU tensors.  All four give the same sorted final multiset and
counters, because every draw is keyed by particle genealogy (rng.py).

Protocol: a mobility phase returns ``(state, info)`` with the exact push
count as a base-2^30 pair ``pushes_lo``/``pushes_hi``; a self-compacting
phase (``fn.self_compacting``) returns the compacted state and adds
``added``, ``removed`` and ``overflow``; any other phase may add
``reclaimed``, the dead rows it dropped mid-phase.
"""

from __future__ import annotations

import torch

from .config import SimConfig
from .ops import population
from .ops.physics import update_particles
from .ops.step import active_mask, state_to_particles
from .state import SimState

PUSH_BASE = 1 << 30


def pushes_info(total: int) -> dict:
    """An exact push count as the base-2^30 pair of the JAX package."""
    return {"pushes_lo": total % PUSH_BASE, "pushes_hi": total // PUSH_BASE}


def _one_step(state: SimState, t: int, poisson_step: int, table, config,
              reclaim: bool, lo: int = 0, hi: int = -1):
    """One mobility step over the slots [lo, hi) (default: the live
    prefix), in place; returns (state, lanes that moved as a 0-d tensor,
    rows reclaimed)."""
    hi = state.n_clamped if hi < 0 else hi
    p = state_to_particles(state, hi, lo)
    active = active_mask(p.status, t)
    res = update_particles(
        p, active=active, t=t, poisson_step=poisson_step,
        dt=config.mobility_dt, sim_size=config.sim_size, seed=config.seed,
        table=table, rng_rounds=config.rng_rounds, rng_mode=config.rng_mode,
    )
    q = res.particles
    state.pos[lo:hi] = torch.stack([q.px, q.py, q.pz], 1)
    state.vel[lo:hi] = torch.stack([q.vx, q.vy, q.vz], 1)
    state.status[lo:hi] = q.status
    reclaimed = 0
    if reclaim and state.n + int(res.spawn.sum()) > state.capacity:
        state, reclaimed = population.reclaim(state)
    state = population.append_children(state, res.spawn, res.child)
    return state, active.sum(), reclaimed


def mobility_phase_naive(state: SimState, poisson_step: int, table,
                         config: SimConfig, t_steps: int,
                         reclaim: bool = False):
    """Steps 1..t_steps over all live slots (works on a copy of the
    state's tensors).

    The naive cadence keeps dead slots until the step's compaction, so the
    container must hold the phase's cumulative appends.  ``reclaim=True``
    drops dead rows whenever a step's children would not fit (the JAX
    package's host-chunked naive path does the same), so only the live
    population bounds the container; ``info["reclaimed"]`` counts the rows
    dropped."""
    state = SimState(*(x.clone() for x in state[:6]), state.n)
    pushes = torch.zeros((), dtype=torch.int64, device=state.device)
    reclaimed = 0
    for t in range(1, t_steps + 1):
        state, moved, r = _one_step(state, t, poisson_step, table, config,
                                    reclaim)
        pushes += moved
        reclaimed += r
    return state, {"reclaimed": reclaimed, **pushes_info(int(pushes))}


def mobility_phase_sync(state: SimState, poisson_step: int, table,
                        config: SimConfig, t_steps: int):
    """Generation fixed point: the slots [gen_lo, gen_hi) run through steps
    1..t_steps, then the slots their steps appended, until the population
    stops growing (at most t_steps + 1 generations: a child spawned at
    step t starts at t + 1).  Works on a copy of the state's tensors."""
    state = SimState(*(x.clone() for x in state[:6]), state.n)
    pushes = torch.zeros((), dtype=torch.int64, device=state.device)
    gen_lo = 0
    while state.n_clamped > gen_lo:
        gen_hi = state.n_clamped
        # no lane of the generation moves before its earliest start
        first = int(torch.clamp(state.status[gen_lo:gen_hi], min=0).min()) + 1
        for t in range(first, t_steps + 1):
            state, moved, _ = _one_step(state, t, poisson_step, table, config,
                                        False, gen_lo, gen_hi)
            pushes += moved
        gen_lo = gen_hi
    return state, pushes_info(int(pushes))


def get_mobility_phase(name: str):
    if name == "naive":
        return mobility_phase_naive
    if name == "sync":
        return mobility_phase_sync
    if name == "dynamic":
        from .ops.kernels.worklog import mobility_phase_worklog

        return mobility_phase_worklog
    if name == "dynamic_old":
        from .ops.kernels.push_mcc import mobility_phase_dynamic

        return mobility_phase_dynamic
    raise ValueError(f"unknown scheduler {name!r}")
