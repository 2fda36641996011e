"""The subgrid field phase's kernel chain (ops/kernels/field.py
``subgrid_bbox``, ``subgrid_deposit``, ``subgrid_field_store``, and
``ops.grid.subgrid_field_chain`` that runs them) through the plain twins
on the CPU, against the PyTorch chain that the CPU's field phase runs
(``live_bbox`` and ``fit_window``, ``subgrid_ids`` and ``subgrid_deposit``,
``ops.step.grid_phase``), which tests/test_torch_field.py holds to the
JAX package.  The card's kernels are held to these twins in
tests/test_torch_field_kernels.py.

Tolerance: exact (int32 equality; the float32 field bit for bit).
"""

import numpy as np
import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.constants import (
    STATUS_ALIVE, electric_force_constant,
)
from particle_simulation_tpu_torch.ops import grid as grid_ops
from particle_simulation_tpu_torch.ops import population
from particle_simulation_tpu_torch.ops.kernels import field
from particle_simulation_tpu_torch.ops.step import grid_phase
from particle_simulation_tpu_torch.state import zero_state

CELL = 0.5
E = electric_force_constant(CELL)
GRID = (160, 160, 160)
CAPACITY = 4096
M = 3000
CASES = ("clustered", "empty", "all_dead", "global_edge", "dense", "spread")


def make_rows(case, S, seed=0):
    """(pos (CAPACITY, 3) float32, status (CAPACITY,) int32, m) of one case
    on the 160^3 grid: dead slots among the first m rows, and rows past m
    that are live-looking and lie outside every box (they must count for
    nothing and get 0).

    * clustered: a cube of S-10 cells from cell 40;
    * empty: m = 0; all_dead: m rows, none live;
    * global_edge: cells [g-S+1, g-1], an extent of S-1 that fits only at
      the global edge (its lowest and highest cell occupied);
    * dense: the clustered cube with 600 rows in one cell and 8 in a
      neighbour, so that a neighbour difference exceeds 511 (the PyTorch
      chain's rows fallback);
    * spread: the whole grid, wider than any window."""
    rng = np.random.default_rng(seed + S)
    lo, hi = {"global_edge": (GRID[0] - S + 1, GRID[0]),
              "spread": (0, GRID[0])}.get(case, (40, 30 + S))
    cells = rng.integers(lo, hi, (CAPACITY, 3))
    pos = (cells + rng.uniform(0.0, 0.999, (CAPACITY, 3))) * CELL
    pos[0], pos[1] = (lo + 0.5) * CELL, (hi - 0.5) * CELL
    if case == "dense":
        pos[2:602] = 45.5 * CELL
        pos[602:610] = (46.5 * CELL, 45.5 * CELL, 45.5 * CELL)
    pos[M:] = 5.5 * CELL  # past m: outside every box above
    status = np.full(CAPACITY, STATUS_ALIVE, np.int32)
    status[rng.uniform(size=CAPACITY) < 0.3] = -2  # dead
    status[:2] = STATUS_ALIVE
    status[100:200] = rng.integers(1, 50, 100)      # spawned: live
    if case == "dense":
        status[2:610] = STATUS_ALIVE
    if case == "all_dead":
        status[:] = -2
    m = 0 if case == "empty" else M
    return (torch.from_numpy(pos.astype(np.float32)),
            torch.from_numpy(status), m)


def chain_bounds(pos, status, m):
    """live_bbox's (lo, hi) of the PyTorch chain, as lists."""
    weight = population.is_live(status[:m]).to(torch.int32)
    idx = grid_ops.cell_indices(pos[:m], CELL, GRID)
    lo, hi = grid_ops.live_bbox(idx, weight, GRID)
    return lo.tolist(), hi.tolist()


def chain_window(pos, status, m, S):
    """(origin, fits, flat ids, weight) of the PyTorch chain."""
    weight = population.is_live(status[:m]).to(torch.int32)
    idx = grid_ops.cell_indices(pos[:m], CELL, GRID)
    origin, fits = grid_ops.fit_window(
        *grid_ops.live_bbox(idx, weight, GRID), GRID, S)
    return origin, fits, idx, weight


def chain_acc(pos, status, m, S):
    """The CPU field phase's acc (ops.step.grid_phase, PyTorch chain)."""
    cfg = SimConfig(cell_size=CELL, grid_size=GRID, bbox_subgrid=S,
                    capacity=CAPACITY)
    st = zero_state(cfg, "cpu")._replace(pos=pos, status=status, n=m)
    grid_ops.field_counts.reset()
    return grid_phase(st, cfg).acc


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_subgrid_bbox_plain_matches_live_bbox(case, S):
    """The six words decode to live_bbox's bounds, sentinels included, and
    give fit_window's origin and test."""
    pos, status, m = make_rows(case, S)
    words = field.subgrid_bbox_plain(pos, status, m, CELL, GRID)
    assert words.dtype == torch.int32 and words.shape == (6,)
    lo, hi = field.bbox_bounds(words.tolist(), GRID)
    assert (lo, hi) == chain_bounds(pos, status, m)
    origin, fits, _, _ = chain_window(pos, status, m, S)
    assert grid_ops.window_of(lo, hi, GRID, S) == (origin, fits)
    assert fits == (case != "spread")
    if case in ("empty", "all_dead"):
        assert lo == list(GRID) and hi == [-1, -1, -1]
    if case == "global_edge":
        assert hi == [g - 1 for g in GRID]
        assert [h - o for h, o in zip(hi, origin)] == [S - 1] * 3


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("case", [c for c in CASES if c != "spread"])
def test_subgrid_deposit_plain_matches_index_add(case, S):
    """The counts equal the PyTorch chain's subgrid_ids + index_add_."""
    pos, status, m = make_rows(case, S)
    origin, fits, idx, weight = chain_window(pos, status, m, S)
    assert fits
    want = grid_ops.subgrid_deposit(
        grid_ops.subgrid_ids(idx, weight, origin, S), S)
    got = field.subgrid_deposit_plain(pos, status, m, CELL, GRID, origin, S)
    assert got.dtype == torch.int32 and got.shape == (S ** 3,)
    assert torch.equal(got, want)
    assert int(got.sum()) == int(weight.sum())
    if case == "dense":
        assert int(got.max()) >= 600


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("case", [c for c in CASES if c != "spread"])
def test_subgrid_field_store_plain_matches_the_chain(case, S):
    """The store's acc equals grid_phase's at capacity bit for bit: the
    field at the live rows, 0 at the dead ones and at every row past m;
    the dense case is the one the PyTorch chain gathers as float32 rows."""
    pos, status, m = make_rows(case, S)
    want = chain_acc(pos, status, m, S)
    assert grid_ops.field_counts.rows_fallback == int(case == "dense")
    origin, _, _, _ = chain_window(pos, status, m, S)
    counts = field.subgrid_deposit_plain(pos, status, m, CELL, GRID, origin,
                                         S)
    got = field.subgrid_field_store_plain(pos, status, m, CELL, GRID, origin,
                                          S, counts, E)
    assert got.dtype == torch.float32 and got.shape == (CAPACITY, 3)
    assert torch.equal(_bits(got), _bits(want))
    assert (_bits(got[m:]) == 0).all()
    live = population.is_live(status[:m])
    assert (_bits(got[:m][~live]) == 0).all()
    if case in ("clustered", "global_edge", "dense"):
        assert (got[:m][live] != 0).any()
    if case == "dense":
        assert float(got.abs().max()) > 511 * np.float32(E)


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_chain_matches_grid_phase_with_one_readback(case, S):
    """``subgrid_field_chain`` on CPU tensors (the plain twins) gives the
    PyTorch chain's acc and path with one readback against two, and no
    rows fallback; a box wider than the window returns None."""
    pos, status, m = make_rows(case, S)
    want = chain_acc(pos, status, m, S)
    path = grid_ops.field_counts.last
    assert grid_ops.field_counts.readbacks == 2
    grid_ops.field_counts.reset()
    got = grid_ops.subgrid_field_chain(pos, status, m, CELL, GRID, E, S)
    assert grid_ops.field_counts.readbacks == 1
    assert grid_ops.field_counts.rows_fallback == 0
    if case == "spread":
        assert got is None and path == "window_fallback"
        assert grid_ops.field_counts.last == ""
        return
    assert path == "subgrid" and grid_ops.field_counts.last == "subgrid"
    assert torch.equal(_bits(got), _bits(want))


def test_cpu_wrappers_take_the_plain_twins():
    """On CPU tensors each wrapper returns its twin's result and launches
    nothing."""
    pos, status, m = make_rows("clustered", 64)
    fns = (field.subgrid_bbox, field.subgrid_deposit,
           field.subgrid_field_store)
    before = [f.launches for f in fns]
    words = field.subgrid_bbox(pos, status, m, CELL, GRID)
    assert torch.equal(words, field.subgrid_bbox_plain(pos, status, m, CELL,
                                                       GRID))
    origin = grid_ops.window_of(*field.bbox_bounds(words.tolist(), GRID),
                                GRID, 64)[0]
    counts = field.subgrid_deposit(pos, status, m, CELL, GRID, origin, 64)
    assert torch.equal(counts, field.subgrid_deposit_plain(
        pos, status, m, CELL, GRID, origin, 64))
    acc = field.subgrid_field_store(pos, status, m, CELL, GRID, origin, 64,
                                    counts, E)
    assert torch.equal(acc, field.subgrid_field_store_plain(
        pos, status, m, CELL, GRID, origin, 64, counts, E))
    assert [f.launches for f in fns] == before


def test_subgrid_wrappers_reject_bad_inputs():
    pos, status, m = make_rows("clustered", 64)
    with pytest.raises(ValueError, match="float32"):
        field.subgrid_bbox(pos.double(), status, m, CELL, GRID)
    with pytest.raises(ValueError, match="int32"):
        field.subgrid_bbox(pos, status.long(), m, CELL, GRID)
    with pytest.raises(ValueError, match="capacity"):
        field.subgrid_deposit(pos, status, CAPACITY + 1, CELL, GRID,
                              [0, 0, 0], 64)
    with pytest.raises(ValueError, match="counts"):
        field.subgrid_field_store(pos, status, m, CELL, GRID, [0, 0, 0], 64,
                                  torch.zeros(8, dtype=torch.int32), E)
    with pytest.raises(ValueError, match="subgrid edge"):
        grid_ops.subgrid_field_chain(pos, status, m, CELL, GRID, E, 12)
