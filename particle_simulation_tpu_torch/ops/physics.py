"""Per-particle physics: leapfrog push, bounds kill, Monte-Carlo collision
(counterpart of ``particle_simulation_tpu/ops/physics.py``, leapfrog
integrator, reverse collision model and absorbing boundary).

Reference semantics (src/particle_move.cu): kick-drift-kick with v MINUS
a*dt/2 (:22-39); out-of-bounds kills before any collision roll (:41-52);
one uniform draw in [0, 100), energy |v|^2, log-bucket table lookup,
u < split -> ionize (the child copies the moved parent, the parent's
velocity reverses), elif u < split + remove -> absorbed (:55-80).

The float32 arithmetic follows XLA's, site for site (fma.py): the drift is
``fma(fma(-a, dt/2, v), dt, p)`` — XLA recomputes the mid-step velocity
inside the position fusion and contracts both multiply-adds there — while
the velocity itself is ``(v - k) - k`` with ``k = a * (dt/2)`` rounded.
``csrc/physics.cuh`` computes the same expressions with ``__fmaf_rn``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..constants import STATUS_DEAD
from ..cross_section import table_lookup
from ..fma import fma_f32


class Particles(NamedTuple):
    """Component-wise particle bundle; every field has the same shape."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor
    status: torch.Tensor  # i32
    id_hi: torch.Tensor   # i32 bit pattern
    id_lo: torch.Tensor   # i32 bit pattern


class StepResult(NamedTuple):
    particles: Particles   # updated parents (only valid where active)
    spawn: torch.Tensor    # bool: a child was created this step
    child: Particles       # child fields (only valid where spawn)


def f32(x) -> float:
    """A Python float rounded to float32 (kept as a Python float)."""
    return float(np.float32(x))


def half_dt(dt) -> float:
    """float32(dt) / 2, the leapfrog half-kick factor (exact halving)."""
    return float(np.float32(dt) / np.float32(2))


def make_kick(acc, dt):
    """The half-kicks a*dt/2 per axis, loop constants of a mobility phase."""
    h = half_dt(dt)
    return tuple(a * h for a in acc)


def leapfrog(p: Particles, dt) -> Particles:
    kick = make_kick((p.ax, p.ay, p.az), dt)
    dt32, h = f32(dt), half_dt(dt)
    pos = []
    for x, v, a in ((p.px, p.vx, p.ax), (p.py, p.vy, p.ay),
                    (p.pz, p.vz, p.az)):
        pos.append(fma_f32(fma_f32(-a, h, v), dt32, x))
    kx, ky, kz = kick
    return p._replace(
        px=pos[0], py=pos[1], pz=pos[2],
        vx=(p.vx - kx) - kx, vy=(p.vy - ky) - ky, vz=(p.vz - kz) - kz,
    )


def out_of_bounds(p: Particles, sim_size) -> torch.Tensor:
    if sim_size[0] == sim_size[1] == sim_size[2]:
        # cubic domain: the min/max fold of the JAX package (same results
        # for finite coordinates)
        s = f32(sim_size[0])
        m = torch.minimum(torch.minimum(p.px, p.py), p.pz)
        big = torch.maximum(torch.maximum(p.px, p.py), p.pz)
        return (m < 0) | (big >= s)
    sx, sy, sz = (f32(s) for s in sim_size)
    return (
        (p.px < 0) | (p.px >= sx)
        | (p.py < 0) | (p.py >= sy)
        | (p.pz < 0) | (p.pz >= sz)
    )


def collision_energy(p: Particles) -> torch.Tensor:
    """|v|^2 as XLA computes it: fma(vz, vz, fma(vx, vx, vy*vy))."""
    return fma_f32(p.vz, p.vz, fma_f32(p.vx, p.vx, p.vy * p.vy))


def update_particles(
    p: Particles,
    active: torch.Tensor,
    t: int,
    poisson_step: int,
    dt: float,
    sim_size,
    seed: int,
    table: torch.Tensor,
    rng_rounds: int = 20,
    rng_mode: str = "perstep",
) -> StepResult:
    """One mobility step for every lane; inactive lanes pass through.

    ``table`` is the (N_STEPS, 2) chance table, read at
    ``energy_to_index(|v|^2)`` and compared in float32 as
    ``u < split`` and ``u < split + remove``."""
    moved = leapfrog(p, dt)
    oob = out_of_bounds(moved, sim_size)
    in_dom = active & ~oob
    oob_kill = active & oob

    u, child_hi, child_lo = rng.step_draws_mode(
        rng_mode, seed, p.id_hi, p.id_lo, poisson_step, t, 0.0, 100.0,
        rounds=rng_rounds,
    )
    # energies gated to active lanes, as the JAX package does
    energy = torch.where(active, collision_energy(moved),
                         torch.zeros_like(moved.vx))
    split, remove = table_lookup(table, energy)
    splits = in_dom & (u < split)
    dies = oob_kill | (in_dom & ~splits & (u < split + remove))

    child = moved._replace(
        status=torch.full_like(p.status, int(t)),
        id_hi=rng.to_i32(child_hi),
        id_lo=rng.to_i32(child_lo),
    )

    def sel(new, old):
        return torch.where(active, new, old)

    def flip(v):
        return torch.where(splits, -v, v)

    parents = p._replace(
        px=sel(moved.px, p.px),
        py=sel(moved.py, p.py),
        pz=sel(moved.pz, p.pz),
        vx=sel(flip(moved.vx), p.vx),
        vy=sel(flip(moved.vy), p.vy),
        vz=sel(flip(moved.vz), p.vz),
        status=torch.where(
            dies, torch.full_like(p.status, STATUS_DEAD), p.status
        ),
    )
    return StepResult(particles=parents, spawn=splits, child=child)
