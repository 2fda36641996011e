"""Correctly rounded fused multiply-adds (float32 and float64) on torch
tensors, and the elementary functions of the model.

The JAX package's reference results come from XLA, which contracts some
``a*b + c`` expressions into one fused multiply-add: the product is not
rounded before the add.  To reproduce those results bit for bit, the port
writes each such site as ``fma_f32`` (plain torch) or ``__fmaf_rn`` (the CUDA
kernel).  The sites, measured against XLA:CPU over 10^5-10^6 random inputs:

* the drift ``px + vx*dt`` (ops/physics.py), whose ``vx`` XLA recomputes as
  ``fma(-ax, dt/2, vx)`` inside the same fusion;
* ``collision_energy`` = ``fma(vz, vz, fma(vx, vx, vy*vy))``;
* ``energy_to_index``'s ``log(E) * log10(e) + 6`` (cross_section.py);
* the boris push at B = 0: the velocity ``fma(-a, dt, v)`` and the drift
  ``fma(v', dt, p)`` with the new velocity;
* the boris push with a magnetic field, per output axis i (XLA emits one
  fusion for each velocity component): ``v - a*h`` is ``fma(-a, h, v)`` on
  the other two axes, whose product has one use, and twice-rounded on axis
  i, whose product ``a_i*h`` the final ``- h`` uses again; each cross
  product ``x*y - z*w`` is ``fma(x, y, -(z*w))``; the sums ``vm + cross``
  and the final ``- a_i*h`` round on their own; the drift is
  ``fma(v', dt, p)``;
* the isotropic child: ``1 - c*c`` is ``fma(-c, c, 1)`` and its speed is
  ``sqrt(collision_energy)``.

Not every ``a*b + c`` is fused: the leapfrog velocity ``(v - a*h) - a*h``
keeps its product rounded (two uses), ``2*u - 1`` is exact either way,
``speed*sin_t*cos(phi)`` has no add, the constants ``t = Omega*dt/2`` and
``s = 2t/(1 + |t|^2)`` are folded by XLA one float32 operation at a time
(``ops.physics.rotation``), and ``rng.uniform_from_bits`` runs outside
``jit`` in the JAX package's setup, so its scale-and-shift rounds twice.
All of these were measured against XLA:CPU (JAX 0.9.0) over 2 x 10^5
random lanes of the ``sync`` cadence's compiled step.

The model's elementary functions (``sqrt``, ``log``, ``cos``, ``sin``) are
taken in float64 and rounded once (``f32_of_f64``): correctly rounded on
both devices but for a double-rounding case of probability ~2^-28, so the
plain version on the CPU, on the card and the CUDA kernels (which call the
double-precision ``cos``/``sin`` and ``sqrtf``) agree.  XLA:CPU's ``sqrt``
is correctly rounded too; its ``cos``/``sin`` differ from the correctly
rounded value on about 1.3% of arguments in [0, 2pi) and its ``log`` on
about 14% of arguments in (0, 1], by one ulp (torch's float32 ``sqrt`` on
the CPU is not correctly rounded: 0.7% of arguments).

torch has no fused multiply-add that is guaranteed to round once, so it is
emulated in float64: the product of two float32 values is exact in float64,
an error-free TwoSum gives the exact residue of the add, and rounding that
sum to odd before the final float64 -> float32 conversion removes the
double-rounding error (float64 carries more than 24 + 2 bits).

**float64** (``precision="f64"``, the oracle mode).  XLA:CPU contracts the
float64 expressions at the same sites as the float32 ones: measured
against JAX 0.9.0 under ``jax_enable_x64`` over 10^5 random lanes of the
compiled mobility step of every model, the drift and the collision
energy written as a plain multiply and add move results by an ulp and
written fused move none (tests/test_torch_f64.py,
``test_f64_contraction_sites``), and with every site fused the step is
bitwise XLA's (``test_update_particles_f64_bitwise``), as are whole
``naive`` and ``sync`` runs (``test_f64_run_equals_jax_x64``).  The
float64 path therefore calls ``fma`` at the same sites, which for float64
operands is ``fma_f64``: TwoProduct (Veltkamp's split) and TwoSum give
the product and the add exactly, and their two residues are added rounded
to odd before the one final round-to-nearest (Boldo and Melquiond,
"Emulation of a FMA and correctly-rounded sums: proved algorithms using
rounding to odd", IEEE TC 2008): correctly rounded for finite values away
from the underflow range (an infinite operand gives the plain ``a*b +
c``; ``test_fma_f64_correctly_rounded`` checks it against exact
rationals).  The float64 ``sqrt``, ``cos``, ``sin`` and ``log``
(``elementary``) are numpy's on a CPU tensor, whose ``sqrt``, ``cos`` and
``sin`` equal XLA:CPU's on 10^5 random arguments
(``test_elementary_f64_matches_xla``; torch's own CPU functions are
vectorised approximations that are not correctly rounded), and torch's
CUDA functions on the card, which are not held to XLA's.
"""

from __future__ import annotations

import numpy as np
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


def f32_of_f64(fn, x: torch.Tensor) -> torch.Tensor:
    """float32(fn(float64(x))): an elementary function of float32 values,
    correctly rounded (module docstring)."""
    return fn(x.to(torch.float64)).to(torch.float32)


def _two_sum(a, b):
    """(s, e) with s = round(a + b) and s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Veltkamp's split: hi + lo == a, each half of 26 bits or fewer."""
    c = a * 134217729.0  # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _add_round_odd(a, b):
    """a + b rounded to odd: an inexact sum with an even last bit moves
    one ulp toward the exact value."""
    s, e = _two_sum(a, b)
    fix = (e != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where(fix, torch.nextafter(s, toward), s)


def fma_f64(a, b, c) -> torch.Tensor:
    """round_f64(a*b + c) with a single rounding; float64 tensors (or
    Python floats) broadcast together (module docstring)."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (x if isinstance(x, torch.Tensor) else
               torch.tensor(x, dtype=torch.float64, device=ref.device)
               for x in (a, b, c))
    uh = a * b
    (ah, al), (bh, bl) = _split(a), _split(b)
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl  # uh + ul == a*b
    th, tl = _two_sum(c, uh)
    r = th + _add_round_odd(tl, ul)
    # an infinite operand or product: the residues are NaN, the plain
    # result is the right one
    return torch.where(torch.isfinite(uh) & torch.isfinite(c), r, uh + c)


def fma(a, b, c) -> torch.Tensor:
    """round(a*b + c) once, in the type of the tensor operands: ``fma_f64``
    for float64, ``fma_f32`` otherwise."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    if ref.dtype == torch.float64:
        return fma_f64(a, b, c)
    return fma_f32(a, b, c)


def elementary(name: str, x: torch.Tensor) -> torch.Tensor:
    """The elementary function ``name`` (sqrt, cos, sin, log) of the model:
    for float64 numpy's on a CPU tensor and torch's on the card, for
    float32 ``f32_of_f64`` (module docstring)."""
    if x.dtype != torch.float64:
        return f32_of_f64(getattr(torch, name), x)
    if x.device.type != "cpu":
        return getattr(torch, name)(x)
    with np.errstate(all="ignore"):
        return torch.from_numpy(np.asarray(getattr(np, name)(x.numpy())))
