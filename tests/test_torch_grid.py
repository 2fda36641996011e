"""Port parity: ops/grid (deposit, integer stencil diffs, gathered
acceleration) against the JAX package's grid.deposit and
gather_acceleration_packdiff (the values of its bbox path too).  Bitwise."""

import numpy as np
import pytest
import torch

from particle_simulation_tpu.constants import electric_force_constant
from particle_simulation_tpu.ops import grid as jgrid
from particle_simulation_tpu_torch.ops import grid as tgrid

CELL = 1e-2


def _population(g, n, seed):
    r = np.random.default_rng(seed)
    # a dense seed cube (like setup_particles) plus particles on the edges
    pos = r.uniform(g * CELL * 0.3, g * CELL * 0.7, (n, 3)).astype(np.float32)
    pos[: n // 10] = r.uniform(0.0, g * CELL, (n // 10, 3)).astype(np.float32)
    pos[0] = (0.0, 0.0, 0.0)
    pos[1] = np.nextafter(np.float32(g * CELL), np.float32(0))
    weight = (r.random(n) < 0.9).astype(np.int32)
    return pos, weight


@pytest.mark.parametrize("g", [16, 32])
def test_deposit_diffs_and_gather_bitwise(g):
    grid = (g, g, g)
    pos, weight = _population(g, 20000, g)
    e = electric_force_constant(CELL)
    j_charge = np.asarray(jgrid.deposit(pos, weight, CELL, grid))
    t_pos, t_w = torch.from_numpy(pos), torch.from_numpy(weight)
    t_charge = tgrid.deposit(t_pos, t_w, CELL, grid)
    np.testing.assert_array_equal(j_charge, t_charge.numpy())
    assert t_charge.sum().item() == weight.sum()
    for jd, td in zip(jgrid._int_diffs(j_charge, grid),
                      tgrid._int_diffs(t_charge, grid)):
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    j_acc = np.asarray(jgrid.gather_acceleration_packdiff(
        j_charge, pos, weight, CELL, grid, e))
    t_acc = tgrid.gather_acceleration(t_charge, t_pos, t_w, CELL, grid, e)
    np.testing.assert_array_equal(j_acc, t_acc.numpy())
    assert (t_acc.numpy()[weight == 0] == 0).all()


def test_cell_indices_truncate_and_clamp():
    pos = np.array([[0.0, 0.009999, 0.01], [0.159999, 0.16, 1.0]], np.float32)
    grid = (16, 16, 16)
    np.testing.assert_array_equal(
        np.asarray(jgrid.cell_indices(pos, CELL, grid)),
        tgrid.cell_indices(torch.from_numpy(pos), CELL, grid).numpy(),
    )
