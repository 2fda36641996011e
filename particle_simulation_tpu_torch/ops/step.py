"""Poisson steps (counterpart of ``particle_simulation_tpu/ops/step.py``).

One Poisson step is the field phase (deposit, stencil, gather; the field
then stays frozen), the mobility phase of the configured scheduler and the
compaction of the population (reference src/pic.cu:487-560).
``poisson_loop`` runs several steps and returns the per-step metrics of
the JAX package's ``poisson_loop``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import SimConfig, check_supported
from ..cross_section import table_lookup
from ..state import SimState
from ..utils.profiling import span
from . import grid as grid_ops
from . import population
from ..models.poisson_fft import gather_acceleration_fft
from .physics import Particles

METRIC_KEYS = ("n", "added", "removed", "overflow", "pushes_lo", "pushes_hi")


def state_to_particles(state: SimState, m: int, lo: int = 0) -> Particles:
    """The slots [lo, m) as a Particles bundle."""
    s = slice(lo, m)
    return Particles(
        px=state.pos[s, 0], py=state.pos[s, 1], pz=state.pos[s, 2],
        vx=state.vel[s, 0], vy=state.vel[s, 1], vz=state.vel[s, 2],
        ax=state.acc[s, 0], ay=state.acc[s, 1], az=state.acc[s, 2],
        status=state.status[s], id_hi=state.id_hi[s], id_lo=state.id_lo[s],
    )


def particles_to_state(state: SimState, p: Particles) -> SimState:
    """``state`` with its six tensors from a Particles bundle of its
    capacity (the inverse of ``state_to_particles(state, capacity)``)."""
    return state._replace(
        pos=torch.stack([p.px, p.py, p.pz], dim=1),
        vel=torch.stack([p.vx, p.vy, p.vz], dim=1),
        acc=torch.stack([p.ax, p.ay, p.az], dim=1),
        status=p.status, id_hi=p.id_hi, id_lo=p.id_lo,
    )


def make_table_lookup(table: torch.Tensor) -> Callable:
    """The JAX engines' lookup closure: ``lookup(energy, u=None,
    bits=None)`` -> the (split, remove) chances of each energy's bucket
    (``cross_section.table_lookup``); ``u`` and ``bits`` go unused, as
    there."""

    def lookup(energy, u=None, bits=None):
        return table_lookup(table, energy)

    return lookup


def active_mask(status: torch.Tensor, t: int) -> torch.Tensor:
    """A particle moves at mobility step t iff it is live and was spawned
    before t (children spawned at t start at t+1; reference
    src/pic.cu:218)."""
    return population.is_live(status) & (t > torch.clamp(status, min=0))


def grid_phase(state: SimState, config: SimConfig) -> SimState:
    """Deposit the live particles' charge and store each one's frozen
    acceleration (reference src/grid_operations.cu, src/pic.cu:497-503).

    The path is the JAX package's (``field_acceleration``): under the
    neighbour model the bbox subgrid when ``bbox_subgrid`` is set (with
    its full-grid fallback), else the full grid, both gathering the packed
    diffs; under ``field_model="fft"`` the full-grid deposit and the
    spectral solve (models/poisson_fft.py); else, under ``precision=
    "f64"``, the full-grid deposit and the float64 gather
    (``grid_ops.gather_acceleration``).  A float32 CUDA state takes the
    subgrid as ``grid_ops.subgrid_field_chain``'s three kernels, which
    write the new ``acc`` themselves after one readback (the window test);
    every other case runs the PyTorch chain, with at most two readbacks.
    ``grid_ops.field_counts`` records the path taken and the readbacks.
    The phase is the span ``pst.field`` (``utils.profiling.span``)."""
    with span("pst.field"):
        m = state.n_clamped
        e = config.electric_force_constant
        subgrid = (config.bbox_subgrid and config.field_model == "neighbour"
                   and state.pos.dtype == torch.float32)
        on_card = subgrid and state.pos.is_cuda
        if on_card:
            acc = grid_ops.subgrid_field_chain(
                state.pos, state.status, m, config.cell_size,
                config.grid_size, e, config.bbox_subgrid)
            if acc is not None:
                return state._replace(acc=acc)
        pos = state.pos[:m]
        weight = population.is_live(state.status[:m]).to(torch.int32)
        if on_card:
            a = grid_ops.window_fallback_acceleration(
                pos, weight, config.cell_size, config.grid_size, e)
        elif subgrid:
            a = grid_ops.bbox_field_acceleration(
                pos, weight, config.cell_size, config.grid_size, e,
                subgrid=config.bbox_subgrid,
            )
        else:
            grid_ops.field_counts.note(
                "fft" if config.field_model == "fft"
                else "f64" if pos.dtype == torch.float64 else "full")
            with span("pst.field.deposit"):
                charge = grid_ops.deposit(pos, weight, config.cell_size,
                                          config.grid_size)
            a = field_acceleration(charge, pos, weight, config)
        with span("pst.field.store"):
            acc = torch.zeros_like(state.acc)
            acc[:m] = a
        return state._replace(acc=acc)


def field_acceleration(charge, pos, weight, config: SimConfig):
    """The field at each particle from the full grid's charge counts, by
    the configured model (the JAX package's dispatch): the spectral solve
    under ``field_model="fft"``; under the neighbour model the float64
    gather for float64 positions, else the packed diffs."""
    if config.field_model == "fft":
        return gather_acceleration_fft(charge, pos, weight, config.cell_size,
                                       config.grid_size)
    if config.field_model != "neighbour":
        raise ValueError(f"unknown field model {config.field_model!r}")
    e = config.electric_force_constant
    if pos.dtype == torch.float64:
        return grid_ops.gather_acceleration(
            charge, pos, weight, config.cell_size, config.grid_size, e)
    return grid_ops.gather_acceleration_packdiff(
        charge, pos, weight, config.cell_size, config.grid_size, e)


def mobility_step(
    state: SimState, poisson_index: int, table: torch.Tensor,
    config: SimConfig, phase: Optional[Callable] = None,
) -> Tuple[SimState, Dict]:
    """The mobility phase of one Poisson step on a state whose field phase
    has run, and the compaction with its accounting; returns (compacted
    state, metrics).  A self-compacting phase reports added and overflow
    itself; any other is compacted here, the rows it reclaimed mid-phase
    folded back into added and removed.  ``parallel.sharded`` calls it
    after its own field phase.  The step is the span ``pst.mobility``."""
    with span("pst.mobility"):
        return _mobility_step(state, poisson_index, table, config, phase)


def _mobility_step(state: SimState, poisson_index: int, table: torch.Tensor,
                   config: SimConfig, phase: Optional[Callable]
                   ) -> Tuple[SimState, Dict]:
    from ..schedulers import get_mobility_phase

    n_start = state.n_clamped
    phase = phase or get_mobility_phase(config.scheduler)
    state, info = phase(
        state, int(poisson_index), table, config, config.poisson_timestep
    )
    if getattr(phase, "self_compacting", False):
        compacted = state
        added = info["added"]
        overflow = info["overflow"]
        removed = n_start + added - compacted.n
    else:
        # rows a phase reclaimed mid-phase would still be in the container
        # without reclamation: fold them back into added and removed
        reclaimed = info.get("reclaimed", 0)
        overflow = state.n > state.capacity
        added = state.n_clamped - n_start + reclaimed
        compacted = population.compact(state)
        removed = state.n_clamped - compacted.n + reclaimed
    return compacted, {
        "n": compacted.n,
        "added": added,
        "removed": removed,
        "overflow": bool(overflow),
        "pushes_lo": info["pushes_lo"],
        "pushes_hi": info["pushes_hi"],
    }


def poisson_step(
    state: SimState, poisson_index: int, table: torch.Tensor,
    config: SimConfig, phase: Optional[Callable] = None,
) -> Tuple[SimState, Dict]:
    """One Poisson step; returns (compacted state, metrics).

    ``phase`` overrides the scheduler's mobility phase (``chip_smoke.py``
    runs each engine's kernel and its plain version side by side with it)."""
    check_supported(config)
    state = grid_phase(state, config)
    return mobility_step(state, poisson_index, table, config, phase=phase)


def poisson_loop(
    state: SimState, table: torch.Tensor, config: SimConfig, num_steps: int,
    first_index: int = 0, phase: Optional[Callable] = None,
) -> Tuple[SimState, Dict[str, List]]:
    """Run ``num_steps`` Poisson steps; metrics are per-step lists.  A zero
    population makes the remaining steps no-ops with zero metrics
    (reference src/pic.cu:556-559)."""
    metrics: Dict[str, List] = {k: [] for k in METRIC_KEYS}
    for i in range(num_steps):
        if state.n > 0:
            state, m = poisson_step(
                state, first_index + i, table, config, phase=phase
            )
        else:
            m = {k: 0 for k in METRIC_KEYS}
            m["overflow"] = False
        for k in METRIC_KEYS:
            metrics[k].append(m[k])
    return state, metrics
