"""Plain reference of one magnetized-argon episode: the upstream's runPIC
row (src/test.cu:4-41) under the model menu's magnetized-argon selection,
in plain PyTorch, written apart from the program under test and importing
nothing of it.

It extends ``pic_reference`` (the upstream's model), whose Threefry-2x32,
genealogy keys, field, draws, table bucket, float32 fused multiply-add
(emulated exactly in float64) and rows it takes as they are.  What this
model changes:

* set-up: the seed cube's positions as ``pic_reference``, and a thermal
  start: each velocity component ``init_vth * N(0, 1)``, the normal draw
  by Box-Muller on the Threefry block (20 rounds) at counter
  (0xFFFFFFFF, axis + 8) of the particle's id, ``sqrt(-2 log u1) *
  cos(2 pi u2)`` with u1 clamped to 2^-25;
* the push: the Boris scheme (J. P. Boris, 1970) in a uniform field whose
  signed cyclotron vector Omega = qB/m is ``b_field`` (rad/s): half-kick
  ``v- = v - a dt/2``, rotation ``v' = v- + v- x t``, ``v+ = v- + v' x
  s`` with ``t = Omega dt/2`` and ``s = 2t / (1 + |t|^2)``, half-kick
  ``v = v+ - a dt/2``, then the drift ``p + v dt`` with the new velocity;
* the boundary: periodic.  A position is wrapped into [0, size) per axis
  (the exact ``fmod``, plus the size where the remainder is negative),
  then clipped to the float32 just below the size; nothing leaves the box
  and nothing dies at a wall;
* the collision: the same roll and table; an ionising particle keeps its
  velocity, and its child (at the moved particle's position, with its
  acceleration, status t and the minted ids) leaves at the particle's
  speed in the direction drawn from the child's own id words:
  ``cos_t = 2 u(id_hi) - 1``, ``sin_t = sqrt(max(1 - cos_t^2, 0))``,
  ``phi = 2 pi u(id_lo)`` (``u`` the top 24 bits as a float32 in [0, 1)).

Departures from the published physics, as in the program:

* energy is ``|v|^2`` in m^2/s^2, with no 1/2 m, and the table is
  indexed by its log (``pic_reference.bucket``); the argon-like table's
  amplitudes are synthetic (``benchmark/configs/magargon512.json``);
* the field is the upstream's neighbour-count force, not a Poisson
  solve, and its missing neighbours at the box's faces count 0 even in the
  periodic box;
* an ionisation child takes the parent's speed: no energy is lost to the
  ionisation threshold, and no ion is followed;
* the draws are the port's Threefry-2x32 keyed by genealogy, not curand.

The float32 arithmetic is the one the port documents for its kernels
(``csrc/physics.cuh``) and plain versions (``fma.py``): single-rounding
multiply-adds at the drift ``fma(v', dt, p)``, at each cross product
``x*y - z*w`` as ``fma(x, y, -(z*w))``, at ``v - a*h`` on the two axes
other than the output's, at the energy and the bucket, and at the child's
``1 - cos_t^2`` as ``fma(-cos_t, cos_t, 1)``; per output axis i the
kick ``a_i*h`` is rounded and used twice, ``(v_i - a_i*h)`` and the
final ``- a_i*h``; every other operation rounds on its own.  ``t`` and
``s`` are folded one float32 operation at a time.  ``sqrt``, ``log``,
``cos`` and ``sin`` are taken in float64 and rounded once to float32.

``dtype`` other than float32 computes positions, velocities and
accelerations in that type, with plain multiply-adds: bfloat16 is the
control that the comparison must reject.  Rows run in blocks of
``BLOCK_ROWS``, so a step's temporaries stay small at any population.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

import pic_reference as base
from pic_reference import (
    ALIVE, SETUP_CTR, SETUP_ROUNDS, Episode, _f32, _fma, bucket,
    draws, field, rows_of, threefry, uniform,
)

# 2 pi rounded to float32, the constant the program multiplies by
TWO_PI_F32 = float(np.float32(2.0 * np.pi))
# the gaussian's u1 floor, so that log(u1) is finite
GAUSS_U1_MIN = 2.0 ** -25
# rows of one block of a mobility step
BLOCK_ROWS = 1 << 22
# the model this reference computes; ``b_field`` (nonzero) and
# ``init_vth`` (positive) are its parameters
MODEL = {"precision": "f32", "integrator": "boris",
         "collision_model": "isotropic", "boundary": "periodic",
         "field_model": "neighbour"}


def f32_of_f64(fn, x):
    """float32(fn(float64(x))): ``fn`` of float32 values rounded once."""
    return fn(x.to(torch.float64)).to(torch.float32)


def rotation(b_field, dt) -> Optional[Tuple[tuple, tuple]]:
    """The Boris rotation's ``t = b_field * dt/2`` and ``s = 2t / (1 +
    |t|^2)``, each float32 operation rounded on its own (three floats
    each), or None for a zero field."""
    if not any(float(b) != 0.0 for b in b_field):
        return None
    f = np.float32
    h = f(dt) / f(2)
    t = [f(b) * h for b in b_field]
    fac = f(2.0) / (f(1.0) + (t[0] * t[0] + t[1] * t[1] + t[2] * t[2]))
    return tuple(float(x) for x in t), tuple(float(x * fac) for x in t)


def check_model(cfg: dict) -> None:
    """Raise for any model but the one this reference computes."""
    for key, want in MODEL.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference runs {key}={want!r}, not "
                             f"{cfg[key]!r}")
    if rotation(cfg["b_field"], cfg["mobility_dt"]) is None:
        raise ValueError("the reference runs a nonzero b_field")
    if not cfg["init_vth"] > 0:
        raise ValueError("the reference runs a thermal start (init_vth > 0)")
    if len(set(cfg["grid_size"])) != 1:
        raise ValueError("the reference takes a cubic domain")


def gaussian(id_hi, id_lo, axis: int):
    """A standard normal float32 per particle from its id (Box-Muller)."""
    b0, b1 = threefry(id_hi, id_lo, torch.full_like(id_hi, SETUP_CTR),
                      torch.full_like(id_hi, axis + 8), SETUP_ROUNDS)
    u1 = torch.clamp(uniform(b0, 0.0, 1.0), min=GAUSS_U1_MIN)
    u2 = uniform(b1, 0.0, 1.0)
    r = f32_of_f64(torch.sqrt, -2.0 * f32_of_f64(torch.log, u1))
    return r * f32_of_f64(torch.cos, TWO_PI_F32 * u2)


def setup(cfg: dict, seed: int, device, dtype):
    """The seeded initial particles with the thermal start: (pos, vel, acc,
    status, id_hi, id_lo), ids as int64 words."""
    pos, _, acc, status, id_hi, id_lo = base.setup(cfg, seed, device, dtype)
    vth = _f32(cfg["init_vth"])
    vel = torch.stack([(vth * gaussian(id_hi, id_lo, ax)).to(dtype)
                       for ax in range(3)], dim=1)
    return pos, vel, acc, status, id_hi, id_lo


def boris(pos, vel, acc, cfg: dict, dtype):
    """(moved positions, moved velocities) of the Boris push with the
    field, before the wrap."""
    fma = _fma(dtype)
    f32 = dtype == torch.float32
    dt = _f32(cfg["mobility_dt"]) if f32 else cfg["mobility_dt"]
    h = _f32(np.float32(cfg["mobility_dt"]) / np.float32(2)) if f32 \
        else cfg["mobility_dt"] / 2
    t, s = rotation(cfg["b_field"], cfg["mobility_dt"])
    a = acc.to(dtype).unbind(1)
    v = vel.unbind(1)

    def cross(x, y, z, w):  # x*y - z*w
        return fma(x, y, -(z * w))

    vm_fused = [fma(-a[i], h, v[i]) for i in range(3)]
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
    new_pos = [fma(new_v[i], dt, pos[:, i]) for i in range(3)]
    return torch.stack(new_pos, dim=1), torch.stack(new_v, dim=1)


def wrap(pos, size: float):
    """Positions wrapped into [0, size) per axis, clipped to the float32
    below ``size``."""
    r = torch.fmod(pos, size)
    r = torch.where((r != 0) & (r < 0), r + size, r)
    edge = float(np.nextafter(np.float32(size), np.float32(0)))
    return torch.clamp(r, 0.0, edge)


def child_velocity(energy, c_hi, c_lo, dtype):
    """The isotropic child's velocity: speed sqrt(energy) in the
    direction drawn from its id words, (m, 3) in ``dtype``."""
    cos_t = 2.0 * uniform(c_hi, 0.0, 1.0) - 1.0
    sin_t = f32_of_f64(torch.sqrt, torch.clamp(
        base.fma32(-cos_t, cos_t, 1.0), min=0.0))
    phi = TWO_PI_F32 * uniform(c_lo, 0.0, 1.0)
    speed = f32_of_f64(torch.sqrt, energy.to(torch.float32))
    across = speed * sin_t
    return torch.stack([across * f32_of_f64(torch.cos, phi),
                        across * f32_of_f64(torch.sin, phi),
                        speed * cos_t], dim=1).to(dtype)


def step_rows(parts, t: int, poisson_step: int, cfg: dict, seed: int,
              table, dtype):
    """One mobility step over a block of particles: (survivors, children,
    the number that moved)."""
    pos, vel, acc, status, id_hi, id_lo = parts
    fma = _fma(dtype)
    active = t > torch.clamp(status, min=0)
    moved_pos, moved_vel = boris(pos, vel, acc, cfg, dtype)
    moved_pos = wrap(moved_pos,
                     _f32(cfg["grid_size"][0] * cfg["cell_size"]))
    u, c_hi, c_lo = draws(cfg, seed, id_hi, id_lo, poisson_step, t)
    vx, vy, vz = moved_vel.unbind(1)
    energy = torch.where(active, fma(vz, vz, fma(vx, vx, vy * vy)),
                         torch.zeros_like(vx))
    row = table[bucket(energy)]
    split, remove = row[:, 0], row[:, 1]
    splits = active & (u < split)
    dies = active & ~splits & (u < split + remove)

    keep = ~dies
    kids = splits.nonzero().flatten()
    survivors = (
        torch.where(active[:, None], moved_pos, pos)[keep],
        torch.where(active[:, None], moved_vel, vel)[keep],
        acc[keep], status[keep], id_hi[keep], id_lo[keep],
    )
    children = (
        moved_pos[kids],
        child_velocity(energy[kids], c_hi[kids], c_lo[kids], dtype),
        acc[kids], torch.full_like(status[kids], t), c_hi[kids],
        c_lo[kids],
    )
    return survivors, children, int(active.sum())


def mobility_step(parts, t: int, poisson_step: int, cfg: dict, seed: int,
                  table, dtype):
    """One mobility step over every particle, a block of rows at a time;
    returns the survivors followed by the children, the number that moved,
    the number of children and the number of survivors."""
    n = parts[0].shape[0]
    kept: List[tuple] = []
    born: List[tuple] = []
    moved = 0
    for lo in range(0, max(n, 1), BLOCK_ROWS):
        block = tuple(x[lo:lo + BLOCK_ROWS] for x in parts)
        survivors, children, m = step_rows(block, t, poisson_step, cfg,
                                           seed, table, dtype)
        kept.append(survivors)
        born.append(children)
        moved += m
    out = tuple(torch.cat([b[f] for b in kept] + [b[f] for b in born])
                for f in range(6))
    n_kept = sum(b[0].shape[0] for b in kept)
    return out, moved, out[0].shape[0] - n_kept, n_kept


def episode(cfg: dict, seed: int, table: torch.Tensor,
            dtype=torch.float32) -> Episode:
    """One magnetized-argon runPIC row from ``seed``: ``cfg`` holds the
    configuration's and the traffic's keys (``pic_reference.episode``'s,
    and b_field, init_vth); ``table`` is the (10000, 2) float32 chance
    table on the device the reference runs on."""
    check_model(cfg)
    dev = table.device
    parts = setup(cfg, seed, dev, dtype)
    counters = []
    for p in range(cfg["poisson_steps"]):
        n_start = parts[0].shape[0]
        parts = (*parts[:2], field(parts[0], cfg["grid_size"],
                                   cfg["cell_size"]).to(dtype), *parts[3:])
        added = pushes = 0
        overflow = False
        for t in range(1, cfg["poisson_timestep"] + 1):
            parts, moved, kids, kept = mobility_step(
                parts, t, p, cfg, seed, table, dtype)
            pushes += moved
            added += kids
            overflow |= kept + kids > cfg["capacity"]
        n = parts[0].shape[0]
        parts = (*parts[:3], torch.full_like(parts[3], ALIVE), *parts[4:])
        counters.append((n, added, n_start + added - n, overflow, pushes))
        if n == 0:
            break
    return Episode(counters, rows_of(*parts))
