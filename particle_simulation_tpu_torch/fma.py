"""A correctly rounded float32 fused multiply-add on torch tensors.

The JAX package's reference results come from XLA, which contracts some
``a*b + c`` expressions into one fused multiply-add: the product is not
rounded before the add.  To reproduce those results bit for bit, the port
writes each such site as ``fma_f32`` (plain torch) or ``__fmaf_rn`` (the CUDA
kernel).  The sites, measured against XLA:CPU over 10^5-10^6 random inputs:

* the drift ``px + vx*dt`` (ops/physics.py), whose ``vx`` XLA recomputes as
  ``fma(-ax, dt/2, vx)`` inside the same fusion;
* ``collision_energy`` = ``fma(vz, vz, fma(vx, vx, vy*vy))``;
* ``energy_to_index``'s ``log(E) * log10(e) + 6`` (cross_section.py).

Not every ``a*b + c`` is fused: the mobility-step velocity ``(v - a*h) -
a*h`` keeps its product rounded, and ``rng.uniform_from_bits`` runs outside
``jit`` in the JAX package's setup, so its scale-and-shift rounds twice.

torch has no fused multiply-add that is guaranteed to round once, so it is
emulated in float64: the product of two float32 values is exact in float64,
an error-free TwoSum gives the exact residue of the add, and rounding that
sum to odd before the final float64 -> float32 conversion removes the
double-rounding error (float64 carries more than 24 + 2 bits).
"""

from __future__ import annotations

import torch


def fma_f32(a, b, c) -> torch.Tensor:
    """round_f32(a*b + c) with a single rounding; a, b, c float32 tensors
    (or Python floats, taken as float32) broadcast together."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))

    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float32).to(torch.float64)
        return torch.tensor(x, dtype=torch.float32, device=ref.device).to(
            torch.float64
        )

    a64, b64, c64 = f64(a), f64(b), f64(c)
    p = a64 * b64                       # exact: 24 + 24 bits < 53
    s = p + c64
    # TwoSum: s + e == p + c exactly
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    # round to odd: an inexact s with an even last bit moves one ulp
    # toward the exact value
    even = (s.view(torch.int64) & 1) == 0
    fix = (e != 0) & even & torch.isfinite(s)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.to(torch.float32)
