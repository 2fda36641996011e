"""The spectral (FFT) Poisson field model (counterpart of
``particle_simulation_tpu/models/poisson_fft.py``), ``field_model="fft"``.

Periodic Poisson problem on the charge grid:

    lap(phi) = -rho / eps0,    E = -grad(phi),    a = (q_e / m_e) E

with the eigenvalues of the 7-point Laplacian,
``lambda(k) = -(2 - 2 cos(2 pi k / N)) / h^2`` summed over the axes, so that
the discrete Laplacian of ``phi`` reproduces ``-rho/eps0`` (the mean mode
is zeroed: the neutralising background of a periodic plasma), and central
differences for the gradient.  ``rho`` is the electron count of a cell
times e / cell volume.

The transforms are ``torch.fft.rfftn``/``irfftn`` on either device, as the
JAX package leaves them to ``jnp.fft``: no TPU kernel lies on this path.
The two FFT libraries round differently, so the result agrees with the JAX
package's to a tolerance (tests/test_torch_poisson_fft.py states it), not
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    ELECTRON_CHARGE, ELECTRON_MASS, EPSILON0, TWO_PI_F32,
)
from ..fma import f32_of_f64



def _f32(x: float) -> float:
    return float(np.float32(x))


def _laplacian_eigenvalues(shape, cell_size, device) -> torch.Tensor:
    """lambda[kx, ky, kz] (negative semidefinite) in rfftn's layout (the
    last axis halved), float32 as the JAX package computes it; the cosine
    correctly rounded (fma.f32_of_f64)."""
    gx, gy, gz = shape
    h2 = _f32(cell_size * cell_size)

    def eig(n, rfft=False):
        k = torch.arange(n // 2 + 1 if rfft else n, dtype=torch.float32,
                         device=device)
        c = f32_of_f64(torch.cos, TWO_PI_F32 * k / _f32(n))
        return -(2.0 - 2.0 * c) / h2

    return (eig(gx)[:, None, None] + eig(gy)[None, :, None]
            + eig(gz, rfft=True)[None, None, :])


def solve_potential(charge_counts: torch.Tensor, cell_size) -> torch.Tensor:
    """The potential grid (float32) of integer electron counts per cell,
    with the mean (k = 0) mode zeroed."""
    shape = tuple(charge_counts.shape)
    rho = charge_counts.to(torch.float32) * _f32(
        ELECTRON_CHARGE / (cell_size ** 3))
    rhs = -rho / _f32(EPSILON0)
    rhs_k = torch.fft.rfftn(rhs)
    lam = _laplacian_eigenvalues(shape, cell_size, charge_counts.device)
    lam[0, 0, 0] = 1.0  # avoid 0/0; the mode is zeroed below
    phi_k = rhs_k / lam
    phi_k[0, 0, 0] = 0.0
    return torch.fft.irfftn(phi_k, s=shape).to(torch.float32)


def acceleration_grid(charge_counts: torch.Tensor, cell_size) -> torch.Tensor:
    """(gx, gy, gz, 3) electron acceleration a = (q/m) * (-grad phi)."""
    phi = solve_potential(charge_counts, cell_size)
    inv2h = _f32(1.0 / (2.0 * cell_size))

    def grad(axis):
        return (torch.roll(phi, -1, axis) - torch.roll(phi, 1, axis)) * inv2h

    e_field = -torch.stack([grad(0), grad(1), grad(2)], dim=-1)
    return e_field * _f32(ELECTRON_CHARGE / ELECTRON_MASS)


def gather_acceleration_fft(charge_flat, pos, weight, cell_size,
                            grid_size) -> torch.Tensor:
    """(N, 3) acceleration at each particle's cell under the FFT model, 0
    where ``weight`` is 0 (ops.grid.gather_acceleration's counterpart)."""
    from ..ops.grid import cell_indices, flatten_cells

    acc_grid = acceleration_grid(
        charge_flat.reshape(grid_size), cell_size).reshape(-1, 3)
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    acc = acc_grid[flat.long()]
    return torch.where(weight[:, None] > 0, acc, torch.zeros_like(acc))
