"""Counter-based, genealogy-keyed RNG (counterpart of
``particle_simulation_tpu/rng.py``; the same Threefry-2x32 and the same
derivations, so every draw and id is bitwise equal to the JAX package's).

Every particle carries a 64-bit id derived from its genealogy; every draw is
a pure function of (id, poisson_step, mobility_step), so any execution order
gives the same physics.

Representation: ``torch.uint32`` has no add, shift or compare on the CPU,
so 32-bit words travel as int64 tensors holding values in [0, 2^32) and
every operation is masked back to 32 bits.  Inputs may be int32 bit
patterns (how the state stores ids), int64 words or Python ints; use
``to_i32`` to store a word back as an int32 bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

GOLDEN = 0x9E3779B9
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
SETUP_CTR = 0xFFFFFFFF
MASK = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """A 32-bit word (int32 bit pattern, int64 or Python int) as int64 in
    [0, 2^32)."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(int(x) & MASK, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK


def to_i32(w: torch.Tensor) -> torch.Tensor:
    """An int64 word in [0, 2^32) as its int32 bit pattern."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key0, key1, ctr0, ctr1, rounds: int = 20):
    """Threefry-2x32 (Salmon et al., SC'11).  Returns two int64 words."""
    dev = _device(key0, key1, ctr0, ctr1)
    k0, k1 = u32(key0, dev), u32(key1, dev)
    k2 = k0 ^ k1 ^ _KS_PARITY
    x0 = (u32(ctr0, dev) + k0) & MASK
    x1 = (u32(ctr1, dev) + k1) & MASK
    ks = (k0, k1, k2)
    for r in range(rounds):
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, _ROTATIONS[r % 8])
        x1 = x1 ^ x0
        if (r + 1) % 4 == 0:
            inject = (r + 1) // 4
            x0 = (x0 + ks[inject % 3]) & MASK
            x1 = (x1 + ks[(inject + 1) % 3] + inject) & MASK
    return x0, x1


def uniform_from_bits(bits, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Top 24 bits -> float32 uniform in [lo, hi).

    The scale and the shift are rounded separately: the JAX package calls
    ``setup_particles`` outside ``jit``, where each operation runs on its
    own (under ``jit`` XLA:CPU would fuse them into one multiply-add and
    move 11-30% of the seeded positions by one ulp).  The collision draw
    has lo = 0, where both forms agree."""
    u01 = ((u32(bits) >> 8).to(torch.float32)) * (2.0 ** -24)
    return u01 * float(np.float32(hi - lo)) + float(np.float32(lo))


def initial_ids(seed: int, slots):
    """64-bit genealogy ids (hi, lo words) for initial particles."""
    s = u32(slots)
    return threefry2x32(seed, GOLDEN, torch.zeros_like(s), s)


def step_draws(seed, id_hi, id_lo, poisson_step, mob_step, lo=0.0, hi=1.0,
               rounds: int = 20):
    """``rng_mode="perstep"``: one block per particle per mobility step.
    Returns (uniform, child_hi, child_lo)."""
    b0, b1 = threefry2x32(
        u32(id_hi) ^ (int(seed) & MASK), id_lo, poisson_step, mob_step,
        rounds=rounds,
    )
    return uniform_from_bits(b0, lo, hi), b1, b0 ^ GOLDEN


def pair_draws(seed, id_hi, id_lo, poisson_step, t_even, lo=0.0, hi=1.0,
               rounds: int = 20):
    """``rng_mode="block2"``: one block serves steps (t_even, t_even + 1).
    Returns the even and the odd (uniform, child_hi, child_lo) triples."""
    b0, b1 = threefry2x32(
        u32(id_hi) ^ (int(seed) & MASK), id_lo, poisson_step, t_even,
        rounds=rounds,
    )
    even = (uniform_from_bits(b0, lo, hi), b1, b0 ^ GOLDEN)
    odd = (uniform_from_bits(b1, lo, hi), (b0 + GOLDEN) & MASK, b1 ^ GOLDEN)
    return even, odd


def step_draws_mode(mode, seed, id_hi, id_lo, poisson_step, mob_step,
                    lo=0.0, hi=1.0, rounds: int = 20):
    """Per-step draws under ``rng_mode``: "perstep", or "block2" (the pair
    block at ``t & ~1`` selected by the parity of ``t``)."""
    if mode == "perstep":
        return step_draws(
            seed, id_hi, id_lo, poisson_step, mob_step, lo, hi, rounds=rounds
        )
    if mode != "block2":
        raise ValueError(f"unknown rng_mode {mode!r}")
    t = u32(mob_step, _device(id_hi, id_lo))
    even, odd = pair_draws(
        seed, id_hi, id_lo, poisson_step, t & 0xFFFFFFFE, lo, hi,
        rounds=rounds,
    )
    is_odd = (t & 1) == 1
    return tuple(torch.where(is_odd, o, e) for e, o in zip(even, odd))


def child_ids_at(mode, seed, id_hi, id_lo, poisson_step, t, rounds: int = 20):
    """(child_hi, child_lo) minted by a split at mobility step ``t``."""
    _, c_hi, c_lo = step_draws_mode(
        mode, seed, id_hi, id_lo, poisson_step, t, rounds=rounds
    )
    return c_hi, c_lo


def setup_uniform(id_hi, id_lo, axis, lo, hi):
    """Uniform draw for the initial placement along one axis (reference
    src/particle_move.cu:12-15)."""
    b0, _ = threefry2x32(id_hi, id_lo, SETUP_CTR, axis)
    return uniform_from_bits(b0, lo, hi)
