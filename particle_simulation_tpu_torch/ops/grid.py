"""Charge-grid operations: deposition, stencil, gather (counterpart of
``particle_simulation_tpu/ops/grid.py``, full-grid path).

Reference src/grid_operations.cu: each live particle adds +1 to its cell
(:15-26); the per-cell acceleration is (charge[+1] - charge[-1]) per axis
times Electric_Force_Constant, missing neighbours counting 0 (:29-56),
gathered at the particle's own cell (:59-72).

The deposit is an int32 ``index_add_``: integer atomics are exact, so the
counts do not depend on the order of the adds.  The acceleration is
``float32(int diff) * float32(e_const)``, the values of the JAX package's
``gather_acceleration_packdiff`` and of its bbox path.  The bbox subgrid
and the 10-bit diff packing work around the TPU's scatter and are not
ported.
"""

from __future__ import annotations

import numpy as np
import torch


def cell_indices(pos: torch.Tensor, cell_size, grid_size) -> torch.Tensor:
    """Integer cell coordinates trunc(pos / cell_size), clamped into the
    grid; (N, 3) int32."""
    inv = float(np.float32(1.0 / cell_size))
    idx = (pos * inv).to(torch.int32)
    maxes = torch.tensor(grid_size, dtype=torch.int32, device=pos.device) - 1
    return torch.minimum(torch.clamp(idx, min=0), maxes)


def flatten_cells(ix, iy, iz, grid_size):
    gx, gy, gz = grid_size
    return (ix * gy + iy) * gz + iz


def deposit(pos, weight, cell_size, grid_size) -> torch.Tensor:
    """Histogram particle counts into a flat (gx*gy*gz,) int32 grid;
    ``weight`` is 1 for live particles and 0 otherwise."""
    gx, gy, gz = grid_size
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    charge = torch.zeros(gx * gy * gz, dtype=torch.int32, device=pos.device)
    return charge.index_add_(0, flat.long(), weight.to(torch.int32))


def _int_diffs(charge_flat, grid_size):
    """The stencil as integer neighbour differences charge[+1] - charge[-1]
    per axis, missing neighbours 0: three int32 grids."""
    c = charge_flat.reshape(grid_size)
    out = []
    for axis in range(3):
        n = c.shape[axis]
        up = torch.zeros_like(c)
        down = torch.zeros_like(c)
        up.narrow(axis, 0, n - 1).copy_(c.narrow(axis, 1, n - 1))
        down.narrow(axis, 1, n - 1).copy_(c.narrow(axis, 0, n - 1))
        out.append(up - down)
    return tuple(out)


def gather_acceleration(charge_flat, pos, weight, cell_size, grid_size,
                        e_const) -> torch.Tensor:
    """(N, 3) float32 acceleration at each particle's cell, 0 where
    ``weight`` is 0."""
    diffs = _int_diffs(charge_flat, grid_size)
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size).long()
    e = torch.tensor(np.float32(e_const), device=pos.device)
    acc = torch.stack([d.reshape(-1)[flat].to(torch.float32) * e
                       for d in diffs], dim=1)
    return torch.where(weight[:, None] > 0, acc, torch.zeros_like(acc))
