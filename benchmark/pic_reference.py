"""Plain reference of one episode: the upstream's runPIC row
(src/test.cu:4-41) from the seed, in plain PyTorch, written apart from the
program under test and importing nothing of it.

It follows the upstream's semantics as the port states them (the same
Threefry-2x32 and genealogy keys, so every draw and id is reproducible):

* set-up: ``init_n`` electrons uniform in the 62-cell cube at the domain
  centre (src/particle_move.cu:7-19), at rest, ids from the seed;
* each Poisson step: the field phase, then ``poisson_timestep`` mobility
  steps, then compaction with every survivor marked alive
  (src/pic.cu:487-560);
* the field: each live particle adds 1 to its cell; the acceleration at a
  particle is (count[+1] - count[-1]) per axis times the force constant,
  missing neighbours 0 (src/grid_operations.cu).  Counted here from the
  occupied cells alone, so no grid is allocated;
* a mobility step (src/particle_move.cu): kick-drift-kick with
  v - a dt/2, out of bounds dies before the roll, one uniform draw in
  [0, 100), the table bucket of |v|^2, split (the child copies the moved
  particle, the parent's velocity reverses) or absorb.  A child spawned at
  step t moves from t + 1.  Dead rows are dropped and children appended
  after every step: the order of rows changes no draw, since every draw
  is keyed by genealogy.

The float32 arithmetic is the one the port documents for its kernels and
plain versions: the drift ``fma(fma(-a, dt/2, v), dt, p)``, the energy
``fma(vz, vz, fma(vx, vx, vy*vy))`` and the bucket's ``fma(log E,
log10 e, 6)`` are single-rounding multiply-adds (emulated exactly in
float64), everything else rounds per operation.

``dtype`` other than float32 computes positions, velocities and
accelerations in that type, with plain multiply-adds: bfloat16 is the
control that the comparison must reject.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
SETUP_CTR = 0xFFFFFFFF
SETUP_ROUNDS = 20
ALIVE, DEAD = -1, -2
N_STEPS = 10000
LOG10_E = float(np.float32(0.4342944920063019))
BUCKET_SCALE = float(np.float32(N_STEPS / 22.0))
# the upstream's constants (src/electron.h:9-10, src/cell.h:5-7)
ELECTRON_CHARGE = -1.602176487e-19
ELECTRON_MASS = 9.1093837015e-31
EPSILON0 = 8.8541878176e-12
PI = 3.1415926536
# the upstream's model, the only one this reference computes
MODEL = {"precision": "f32", "integrator": "leapfrog",
         "collision_model": "reverse", "boundary": "absorb",
         "field_model": "neighbour", "init_vth": 0.0}


@dataclasses.dataclass
class Episode:
    """What an episode leaves: per Poisson step (n, added, removed,
    overflow, pushes), and the final particles as (n, 12) int32 rows:
    pos, vel, acc as float32 bit patterns, status, id_hi, id_lo."""

    counters: List[Tuple[int, int, int, bool, int]]
    rows: torch.Tensor


def _f32(x: float) -> float:
    return float(np.float32(x))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry(k0, k1, c0, c1, rounds):
    """Threefry-2x32 (Salmon et al., SC'11) on int64 words in [0, 2^32)."""
    k2 = k0 ^ k1 ^ _KS_PARITY
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    ks = (k0, k1, k2)
    for r in range(rounds):
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, _ROTATIONS[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            i = (r + 1) // 4
            x0 = (x0 + ks[i % 3]) & MASK
            x1 = (x1 + ks[(i + 1) % 3] + i) & MASK
    return x0, x1


def uniform(bits, lo: float, hi: float):
    """The top 24 bits as a float32 in [lo, hi): scale and shift rounded
    apart."""
    u01 = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return u01 * _f32(hi - lo) + _f32(lo)


def fma32(a, b, c):
    """round_f32(a*b + c) once: the product is exact in float64, TwoSum
    gives the add's residue, and rounding to odd before the last rounding
    removes the double-rounding error."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))

    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        return torch.tensor(_f32(x), dtype=torch.float64, device=ref.device)

    a, b, c = f64(a), f64(b), f64(c)
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    fix = (e != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where(fix, torch.nextafter(s, toward), s).to(torch.float32)


def _fma(dtype):
    if dtype == torch.float32:
        return fma32
    return lambda a, b, c: a * b + c


def bucket(energy):
    """trunc((log10 E + 6) * N/22) clamped to [0, N-1]
    (src/cross_section.cu:32-35), in float32."""
    e = energy.to(torch.float32)
    x = fma32(torch.log(e), LOG10_E, 6.0)
    idx = torch.trunc(x * torch.tensor(BUCKET_SCALE, device=e.device))
    idx = torch.where(torch.isnan(idx), torch.zeros_like(idx), idx)
    return torch.clamp(idx, 0, N_STEPS - 1).long()


def force_constant(cell_size: float) -> float:
    """e^2 / (4 pi eps0 cell^2 m_e) (src/cell.cu:5)."""
    return (ELECTRON_CHARGE * ELECTRON_CHARGE) / (
        4 * PI * EPSILON0 * cell_size * cell_size * ELECTRON_MASS)


def field(pos, grid, cell_size):
    """(m, 3) float32 acceleration of every particle in ``pos`` (all
    live), from the counts of the occupied cells."""
    dev = pos.device
    inv = _f32(1.0 / cell_size)
    g = torch.tensor(grid, dtype=torch.int64, device=dev)
    idx = torch.minimum(torch.clamp((pos * inv).to(torch.int32).long(),
                                    min=0), g - 1)

    def key(c):
        return (c[:, 0] * grid[1] + c[:, 1]) * grid[2] + c[:, 2]

    cells, counts = torch.unique(key(idx), return_counts=True)

    def count_at(c):
        inside = ((c >= 0) & (c < g)).all(dim=1)
        k = key(torch.clamp(c, min=0))
        at = torch.clamp(torch.searchsorted(cells, k), max=cells.numel() - 1)
        hit = inside & (cells[at] == k)
        return torch.where(hit, counts[at], torch.zeros_like(k))

    e = torch.tensor(_f32(force_constant(cell_size)), device=dev)
    acc = []
    for ax in range(3):
        step = torch.zeros(3, dtype=torch.int64, device=dev)
        step[ax] = 1
        diff = count_at(idx + step) - count_at(idx - step)
        acc.append(diff.to(torch.int32).to(torch.float32) * e)
    return torch.stack(acc, dim=1)


def setup(cfg: dict, seed: int, device, dtype):
    """The seeded initial particles: (pos, vel, acc, status, id_hi,
    id_lo), ids as int64 words."""
    n = cfg["init_n"]
    slots = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(slots)
    id_hi, id_lo = threefry(torch.full_like(slots, seed & MASK),
                            torch.full_like(slots, GOLDEN), zero, slots,
                            SETUP_ROUNDS)
    cell = cfg["cell_size"]
    axes = []
    for ax, g in enumerate(cfg["grid_size"]):
        lo = max(0, g // 2 - 30) * cell
        hi = min(g, g // 2 + 32) * cell
        b0, _ = threefry(id_hi, id_lo, torch.full_like(slots, SETUP_CTR),
                         torch.full_like(slots, ax), SETUP_ROUNDS)
        axes.append(uniform(b0, lo, hi).to(dtype))
    pos = torch.stack(axes, dim=1)
    vel = torch.zeros_like(pos)
    status = torch.full((n,), ALIVE, dtype=torch.int32, device=device)
    return pos, vel, torch.zeros_like(pos), status, id_hi, id_lo


def draws(cfg: dict, seed: int, id_hi, id_lo, poisson_step: int, t: int):
    """(uniform in [0, 100), child_hi, child_lo) of mobility step t."""
    rounds = cfg["rng_rounds"]
    k0 = id_hi ^ (seed & MASK)
    if cfg["rng_mode"] == "perstep":
        b0, b1 = threefry(k0, id_lo, poisson_step & MASK, t, rounds)
        return uniform(b0, 0.0, 100.0), b1, b0 ^ GOLDEN
    if cfg["rng_mode"] != "block2":
        raise ValueError(f"unknown rng_mode {cfg['rng_mode']!r}")
    b0, b1 = threefry(k0, id_lo, poisson_step & MASK, t & ~1, rounds)
    if t & 1:
        return uniform(b1, 0.0, 100.0), (b0 + GOLDEN) & MASK, b1 ^ GOLDEN
    return uniform(b0, 0.0, 100.0), b1, b0 ^ GOLDEN


def mobility_step(parts, t: int, poisson_step: int, cfg: dict, seed: int,
                  table, dtype):
    """One mobility step over every particle; returns the survivors
    followed by the children, the number that moved and the number of
    children."""
    pos, vel, acc, status, id_hi, id_lo = parts
    fma = _fma(dtype)
    active = t > torch.clamp(status, min=0)
    dt = float(np.float32(cfg["mobility_dt"])) if dtype == torch.float32 \
        else cfg["mobility_dt"]
    h = _f32(np.float32(cfg["mobility_dt"]) / np.float32(2)) \
        if dtype == torch.float32 else cfg["mobility_dt"] / 2
    a = acc.to(dtype)
    k = a * h
    moved_pos = fma(fma(-a, h, vel), dt, pos)
    moved_vel = (vel - k) - k
    size = _f32(cfg["grid_size"][0] * cfg["cell_size"])
    if len(set(cfg["grid_size"])) != 1:
        raise ValueError("the reference takes a cubic domain")
    oob = (moved_pos.amin(dim=1) < 0) | (moved_pos.amax(dim=1) >= size)
    in_dom = active & ~oob
    u, c_hi, c_lo = draws(cfg, seed, id_hi, id_lo, poisson_step, t)
    vx, vy, vz = moved_vel.unbind(1)
    energy = torch.where(active, fma(vz, vz, fma(vx, vx, vy * vy)),
                         torch.zeros_like(vx))
    row = table[bucket(energy)]
    split, remove = row[:, 0], row[:, 1]
    splits = in_dom & (u < split)
    dies = (active & oob) | (in_dom & ~splits & (u < split + remove))

    new_pos = torch.where(active[:, None], moved_pos, pos)
    new_vel = torch.where(active[:, None],
                          torch.where(splits[:, None], -moved_vel, moved_vel),
                          vel)
    keep = ~dies
    kids = splits.nonzero().flatten()
    out = (
        torch.cat([new_pos[keep], moved_pos[kids]]),
        torch.cat([new_vel[keep], moved_vel[kids]]),
        torch.cat([acc[keep], acc[kids]]),
        torch.cat([status[keep], torch.full_like(status[kids], t)]),
        torch.cat([id_hi[keep], c_hi[kids]]),
        torch.cat([id_lo[keep], c_lo[kids]]),
    )
    return out, int(active.sum()), int(kids.numel()), int(keep.sum())


def to_i32(w):
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def rows_of(pos, vel, acc, status, id_hi, id_lo):
    """(n, 12) int32 rows: pos, vel, acc as float32 bits, status, ids."""
    return torch.cat([
        pos.to(torch.float32).contiguous().view(torch.int32),
        vel.to(torch.float32).contiguous().view(torch.int32),
        acc.to(torch.float32).contiguous().view(torch.int32),
        status.to(torch.int32)[:, None], to_i32(id_hi)[:, None],
        to_i32(id_lo)[:, None],
    ], dim=1)


def episode(cfg: dict, seed: int, table: torch.Tensor,
            dtype=torch.float32) -> Episode:
    """One runPIC row from ``seed``: ``cfg`` holds the configuration's and
    the traffic's keys (init_n, capacity, grid_size, cell_size,
    mobility_dt, poisson_steps, poisson_timestep, rng_mode, rng_rounds);
    ``table`` is the (10000, 2) float32 chance table on the device the
    reference runs on."""
    for key, want in MODEL.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference runs {key}={want!r}, not "
                             f"{cfg[key]!r}")
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
