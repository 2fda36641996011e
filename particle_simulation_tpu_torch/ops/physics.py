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

Under ``precision="f64"`` the positions and velocities are float64 and the
acceleration stays float32, widened where the kick reads it, as the JAX
package computes under ``jax_enable_x64``: every constant is a float64
(``scalar``), the contracted sites are the same (``fma.fma`` takes the
float64 emulation) and the elementary functions are ``fma.elementary``'s.
The collision draw stays float32 and is compared with the float32 table.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..constants import STATUS_DEAD, TWO_PI_F32
from ..cross_section import table_lookup
from ..fma import elementary, fma


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


def _np_type(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def scalar(x, dtype=torch.float32) -> float:
    """A Python float rounded to ``dtype`` (float32 or float64), kept as a
    Python float."""
    return float(_np_type(dtype)(x))


def half(dt, dtype=torch.float32) -> float:
    """dt / 2 in ``dtype`` (exact halving of the rounded dt), the leapfrog
    half-kick factor."""
    t = _np_type(dtype)
    return float(t(dt) / t(2))


def rotation(b_field, dt, dtype=torch.float32):
    """The boris rotation constants ``(t, s)`` (three floats each) for the
    signed cyclotron vector ``b_field`` (Omega = qB/m, rad/s), or None when
    the field is zero: ``t = Omega * dt/2`` and ``s = 2t / (1 + |t|^2)``,
    one ``dtype`` operation at a time, as XLA folds the JAX package's
    constants."""
    if b_field is None or not any(float(b) != 0.0 for b in b_field):
        return None
    f = _np_type(dtype)
    h = f(dt) / f(2)
    t = [f(b) * h for b in b_field]
    t2 = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
    fac = f(2.0) / (f(1.0) + t2)
    return tuple(float(x) for x in t), tuple(float(x * fac) for x in t)


def make_kick(integrator: str, acc, dt, b_field=None, dtype=torch.float32):
    """The kick terms of the JAX package's ``make_kick`` in ``dtype`` (the
    float32 acceleration widened first): a*dt/2 per axis (leapfrog), a*dt
    (boris at B = 0), or the 9-tuple of boris with a field: the half-kicks
    a*dt/2, then ``t`` and ``s`` (``rotation``)."""
    acc = tuple(a.to(dtype) for a in acc)
    rot = rotation(b_field, dt, dtype) if integrator == "boris" else None
    if rot is not None:
        h = half(dt, dtype)
        return (*(a * h for a in acc), *rot[0], *rot[1])
    scale = half(dt, dtype) if integrator == "leapfrog" else scalar(dt, dtype)
    return tuple(a * scale for a in acc)


def leapfrog(p: Particles, dt) -> Particles:
    fdt = p.vx.dtype
    kx, ky, kz = make_kick("leapfrog", (p.ax, p.ay, p.az), dt, dtype=fdt)
    dtf, h = scalar(dt, fdt), half(dt, fdt)
    pos = []
    for x, v, a in ((p.px, p.vx, p.ax), (p.py, p.vy, p.ay),
                    (p.pz, p.vz, p.az)):
        pos.append(fma(fma(-a.to(fdt), h, v), dtf, x))
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
    fdt = p.vx.dtype
    dtf = scalar(dt, fdt)
    a = tuple(x.to(fdt) for x in (p.ax, p.ay, p.az))
    v = (p.vx, p.vy, p.vz)
    rot = rotation(b_field, dt, fdt)
    if rot is None:
        new_v = [fma(-a[i], dtf, v[i]) for i in range(3)]
    else:
        t, s = rot
        h = half(dt, fdt)
        vm_fused = [fma(-a[i], h, v[i]) for i in range(3)]

        def cross(x, y, z, w):  # x*y - z*w, as XLA contracts it
            return fma(x, y, -(z * w))

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
    pos = [fma(new_v[i], dtf, x) for i, x in
           enumerate((p.px, p.py, p.pz))]
    return p._replace(px=pos[0], py=pos[1], pz=pos[2],
                      vx=new_v[0], vy=new_v[1], vz=new_v[2])


def wrap_periodic(p: Particles, sim_size) -> Particles:
    """Positions wrapped into [0, size) per axis (boundary="periodic"):
    ``jnp.mod`` as XLA computes it (the exact ``fmod``, plus the size where
    the remainder is nonzero and its sign differs from the size's), then
    clipped to ``nextafter(size, 0)`` in the positions' type, the edge
    where a tiny negative value wraps to the size itself."""

    def wrap(x, size):
        f = _np_type(x.dtype)
        s = f(size)
        r = torch.fmod(x, float(s))
        r = torch.where((r != 0) & ((r < 0) != bool(s < 0)), r + float(s), r)
        return torch.clamp(r, 0.0, float(np.nextafter(s, f(0))))

    return p._replace(px=wrap(p.px, sim_size[0]), py=wrap(p.py, sim_size[1]),
                      pz=wrap(p.pz, sim_size[2]))


def out_of_bounds(p: Particles, sim_size) -> torch.Tensor:
    if sim_size[0] == sim_size[1] == sim_size[2]:
        # cubic domain: the min/max fold of the JAX package (same results
        # for finite coordinates)
        s = scalar(sim_size[0], p.px.dtype)
        m = torch.minimum(torch.minimum(p.px, p.py), p.pz)
        big = torch.maximum(torch.maximum(p.px, p.py), p.pz)
        return (m < 0) | (big >= s)
    sx, sy, sz = (scalar(s, p.px.dtype) for s in sim_size)
    return (
        (p.px < 0) | (p.px >= sx)
        | (p.py < 0) | (p.py >= sy)
        | (p.pz < 0) | (p.pz >= sz)
    )


def collision_energy(p: Particles) -> torch.Tensor:
    """|v|^2 as XLA computes it: fma(vz, vz, fma(vx, vx, vy*vy))."""
    return fma(p.vz, p.vz, fma(p.vx, p.vx, p.vy * p.vy))


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
    ``energy_to_index(|v|^2)`` (in the velocities' type) and compared in
    float32 as ``u < split`` and ``u < split + remove``.  The model selections are the
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
        fdt = moved.vx.dtype
        two_pi = TWO_PI_F32 if fdt == torch.float32 else 2.0 * math.pi
        cos_t = 2.0 * rng.uniform_from_bits(child_hi).to(fdt) - 1.0
        sin_t = elementary("sqrt", torch.clamp(
            fma(-cos_t, cos_t, 1.0), min=0.0))
        phi = two_pi * rng.uniform_from_bits(child_lo).to(fdt)
        speed = elementary("sqrt", collision_energy(moved))
        across = speed * sin_t
        child_v = (across * elementary("cos", phi),
                   across * elementary("sin", phi), speed * cos_t)
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
