"""Per-particle physics: push, boundary, Monte-Carlo collision
(counterpart of ``particle_simulation_tpu/ops/physics.py``, with its model
menu: the leapfrog or boris integrator, with or without a magnetic field;
the absorbing or periodic boundary; the reverse or isotropic collision
model).

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
The other models' sites are listed in fma.py; their ``sqrt``, ``cos`` and
``sin`` are correctly rounded (fma.f32_of_f64), where XLA:CPU's ``cos`` and
``sin`` are one ulp off on about 1.3% of arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..constants import STATUS_DEAD, TWO_PI_F32
from ..cross_section import table_lookup
from ..fma import f32_of_f64, fma_f32


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


def rotation(b_field, dt):
    """The boris rotation constants ``(t, s)`` (three floats each) for the
    signed cyclotron vector ``b_field`` (Omega = qB/m, rad/s), or None when
    the field is zero: ``t = Omega * dt/2`` and ``s = 2t / (1 + |t|^2)``,
    one float32 operation at a time, as XLA folds the JAX package's
    constants."""
    if b_field is None or not any(float(b) != 0.0 for b in b_field):
        return None
    h = np.float32(dt) / np.float32(2)
    t = [np.float32(b) * h for b in b_field]
    t2 = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
    fac = np.float32(2.0) / (np.float32(1.0) + t2)
    return tuple(float(x) for x in t), tuple(float(x * fac) for x in t)


def make_kick(integrator: str, acc, dt, b_field=None):
    """The kick terms of the JAX package's ``make_kick``: a*dt/2 per axis
    (leapfrog), a*dt (boris at B = 0), or the 9-tuple of boris with a
    field: the half-kicks a*dt/2, then ``t`` and ``s`` (``rotation``)."""
    rot = rotation(b_field, dt) if integrator == "boris" else None
    if rot is not None:
        h = half_dt(dt)
        return (*(a * h for a in acc), *rot[0], *rot[1])
    scale = half_dt(dt) if integrator == "leapfrog" else f32(dt)
    return tuple(a * scale for a in acc)


def leapfrog(p: Particles, dt) -> Particles:
    kx, ky, kz = make_kick("leapfrog", (p.ax, p.ay, p.az), dt)
    dt32, h = f32(dt), half_dt(dt)
    pos = []
    for x, v, a in ((p.px, p.vx, p.ax), (p.py, p.vy, p.ay),
                    (p.pz, p.vz, p.az)):
        pos.append(fma_f32(fma_f32(-a, h, v), dt32, x))
    return p._replace(
        px=pos[0], py=pos[1], pz=pos[2],
        vx=(p.vx - kx) - kx, vy=(p.vy - ky) - ky, vz=(p.vz - kz) - kz,
    )


def boris(p: Particles, dt, b_field=None) -> Particles:
    """Boris push (the JAX package's ``boris``): the full kick, then the
    drift with the new velocity.  At B = 0 the kick is ``v - a*dt``; with
    a field it is ``v- = v - h``, ``v' = v- + v- x t``, ``v+ = v- + v' x
    s``, ``v = v+ - h`` with ``h = a*dt/2``.  The contraction follows XLA's
    per axis (fma.py lists the sites)."""
    dt32 = f32(dt)
    a = (p.ax, p.ay, p.az)
    v = (p.vx, p.vy, p.vz)
    rot = rotation(b_field, dt)
    if rot is None:
        new_v = [fma_f32(-a[i], dt32, v[i]) for i in range(3)]
    else:
        t, s = rot
        h = half_dt(dt)
        vm_fused = [fma_f32(-a[i], h, v[i]) for i in range(3)]

        def cross(x, y, z, w):  # x*y - z*w, as XLA contracts it
            return fma_f32(x, y, -(z * w))

        new_v = []
        for i in range(3):
            j, k = (i + 1) % 3, (i + 2) % 3
            kick = a[i] * h
            vm = list(vm_fused)
            vm[i] = v[i] - kick
            v1 = {c: vm[c] + cross(vm[(c + 1) % 3], t[(c + 2) % 3],
                                   vm[(c + 2) % 3], t[(c + 1) % 3])
                  for c in (j, k)}
            new_v.append((vm[i] + cross(v1[j], s[k], v1[k], s[j])) - kick)
    pos = [fma_f32(new_v[i], dt32, x) for i, x in
           enumerate((p.px, p.py, p.pz))]
    return p._replace(px=pos[0], py=pos[1], pz=pos[2],
                      vx=new_v[0], vy=new_v[1], vz=new_v[2])


def wrap_periodic(p: Particles, sim_size) -> Particles:
    """Positions wrapped into [0, size) per axis (boundary="periodic"):
    ``jnp.mod`` as XLA computes it (the exact ``fmod``, plus the size where
    the remainder is nonzero and its sign differs from the size's), then
    clipped to ``nextafter(size, 0)``, the float32 edge where a tiny
    negative value wraps to the size itself."""

    def wrap(x, size):
        s32 = np.float32(size)
        r = torch.fmod(x, float(s32))
        r = torch.where((r != 0) & ((r < 0) != bool(s32 < 0)),
                        r + float(s32), r)
        return torch.clamp(r, 0.0, float(np.nextafter(s32, np.float32(0))))

    return p._replace(px=wrap(p.px, sim_size[0]), py=wrap(p.py, sim_size[1]),
                      pz=wrap(p.pz, sim_size[2]))


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
    integrator: str = "leapfrog",
    collision_model: str = "reverse",
    boundary: str = "absorb",
    b_field=None,
) -> StepResult:
    """One mobility step for every lane; inactive lanes pass through.

    ``table`` is the (N_STEPS, 2) chance table, read at
    ``energy_to_index(|v|^2)`` and compared in float32 as
    ``u < split`` and ``u < split + remove``.  The model selections are the
    JAX package's: ``integrator`` leapfrog or boris (with ``b_field``, the
    cyclotron vector), ``boundary`` absorb (out of bounds kills before the
    roll) or periodic (positions wrap, nothing leaves), ``collision_model``
    reverse (the child copies the moved lane, whose velocity flips) or
    isotropic (the child leaves at the lane's speed in a direction drawn
    from its own id words; the lane keeps its velocity)."""
    if integrator == "leapfrog":
        moved = leapfrog(p, dt)
    elif integrator == "boris":
        moved = boris(p, dt, b_field)
    else:
        raise ValueError(f"unknown integrator {integrator!r}")
    if boundary == "periodic":
        moved = wrap_periodic(moved, sim_size)
        in_dom = active
        oob_kill = torch.zeros_like(active)
    elif boundary == "absorb":
        oob = out_of_bounds(moved, sim_size)
        in_dom = active & ~oob
        oob_kill = active & oob
    else:
        raise ValueError(f"unknown boundary {boundary!r}")

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

    if collision_model == "reverse":
        child_v = (moved.vx, moved.vy, moved.vz)
        flip = splits
    elif collision_model == "isotropic":
        cos_t = 2.0 * rng.uniform_from_bits(child_hi) - 1.0
        sin_t = f32_of_f64(torch.sqrt, torch.clamp(
            fma_f32(-cos_t, cos_t, 1.0), min=0.0))
        phi = TWO_PI_F32 * rng.uniform_from_bits(child_lo)
        speed = f32_of_f64(torch.sqrt, collision_energy(moved))
        across = speed * sin_t
        child_v = (across * f32_of_f64(torch.cos, phi),
                   across * f32_of_f64(torch.sin, phi), speed * cos_t)
        flip = torch.zeros_like(splits)
    else:
        raise ValueError(f"unknown collision model {collision_model!r}")

    child = moved._replace(
        vx=child_v[0], vy=child_v[1], vz=child_v[2],
        status=torch.full_like(p.status, int(t)),
        id_hi=rng.to_i32(child_hi),
        id_lo=rng.to_i32(child_lo),
    )

    def sel(new, old):
        return torch.where(active, new, old)

    def flipped(v):
        return torch.where(flip, -v, v)

    parents = p._replace(
        px=sel(moved.px, p.px),
        py=sel(moved.py, p.py),
        pz=sel(moved.pz, p.pz),
        vx=sel(flipped(moved.vx), p.vx),
        vy=sel(flipped(moved.vy), p.vy),
        vz=sel(flipped(moved.vz), p.vz),
        status=torch.where(
            dies, torch.full_like(p.status, STATUS_DEAD), p.status
        ),
    )
    return StepResult(particles=parents, spawn=splits, child=child)


def model_args(config) -> dict:
    """The model keywords of ``update_particles`` from a SimConfig."""
    return dict(integrator=config.integrator,
                collision_model=config.collision_model,
                boundary=config.boundary, b_field=config.b_field)
