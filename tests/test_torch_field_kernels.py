"""The field phase's CUDA kernels (csrc/field.cu) against their plain
PyTorch twins, on the card: the gathers, and the subgrid chain
(``subgrid_bbox``, ``subgrid_deposit``, ``subgrid_field_store``) on the
cases of tests/test_torch_field_chain.py.

These tests need a CUDA GPU and nvcc and skip elsewhere.  This file imports
no JAX, so a GPU machine without JAX runs it (skipping conftest.py):

    python -m pytest tests/test_torch_field_kernels.py -m cuda --noconftest

Tolerance: exact (int32 equality; the float32 field bit for bit).
"""

import numpy as np
import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.constants import electric_force_constant
from particle_simulation_tpu_torch.ops import grid as grid_ops
from particle_simulation_tpu_torch.ops.kernels import build, field
from particle_simulation_tpu_torch.ops.step import grid_phase
from particle_simulation_tpu_torch.state import setup_particles, zero_state
from test_torch_field_chain import CASES, CELL, GRID, make_rows

pytestmark = pytest.mark.cuda

E = electric_force_constant(1e-2)
# rows of the probe's 64^3 bbox table and of a 256^3 full-grid table
TABLE_ROWS = {"bbox64": 2048, "full256": 256 ** 3 // 128}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card with -m cuda)")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda", 0)


def _ids(rows, n, order, seed):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, rows * 128, (n,), generator=g, dtype=torch.int32)
    return torch.sort(ids).values if order == "sorted" else ids


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("order", ["sorted", "random"])
@pytest.mark.parametrize("table", sorted(TABLE_ROWS))
def test_banded_gather_matches_plain(dev, table, order):
    rows_n = TABLE_ROWS[table]
    g = torch.Generator().manual_seed(1)
    tab = torch.randint(0, 1 << 30, (rows_n, 128), generator=g,
                        dtype=torch.int32).to(dev)
    ids = _ids(rows_n, 1 << 20, order, 2).to(dev)
    rows, lanes = (ids >> 7).reshape(-1, 128), (ids & 127).reshape(-1, 128)
    before = field.banded_gather.launches
    got = field.banded_gather(tab, rows, lanes)
    torch.cuda.synchronize()
    assert field.banded_gather.launches == before + 1
    assert torch.equal(got, field.banded_gather_plain(tab, rows, lanes))
    assert torch.equal(got.reshape(-1), tab.reshape(-1)[ids.long()])


@pytest.mark.parametrize("order", ["sorted", "random"])
@pytest.mark.parametrize("table", sorted(TABLE_ROWS))
def test_packed_field_gather_matches_plain(dev, table, order):
    """Dead slots (flat -1, weight 0) and live ids with weight 0 included."""
    cells = TABLE_ROWS[table] * 128
    g = torch.Generator().manual_seed(3)
    d = torch.randint(-511, 512, (3, cells), generator=g, dtype=torch.int32)
    packed = grid_ops.pack_diffs(*d).to(dev)
    flat = _ids(TABLE_ROWS[table], 1_000_003, order, 4)
    flat[::7] = -1
    weight = (flat >= 0).to(torch.int32)
    weight[1::11] = 0
    flat, weight = flat.to(dev), weight.to(dev)
    before = field.packed_field_gather.launches
    got = field.packed_field_gather(packed, flat, weight, E)
    torch.cuda.synchronize()
    assert field.packed_field_gather.launches == before + 1
    want = field.packed_field_gather_plain(packed, flat, weight, E)
    assert got.shape == (flat.numel(), 3) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))
    assert (got[weight == 0] == 0).all()
    assert (got[weight > 0] != 0).any()


def test_bad_inputs_raise_on_the_card(dev):
    tab = torch.zeros((4, 128), dtype=torch.int32, device=dev)
    idx = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        field.banded_gather(tab, idx.long(), idx)
    with pytest.raises(ValueError, match="int32"):
        field.packed_field_gather(tab.reshape(-1), idx[0].cpu(), idx[0], E)


SUBGRID_KERNELS = (field.subgrid_bbox, field.subgrid_deposit,
                   field.subgrid_field_store)


def _launches():
    return [f.launches for f in SUBGRID_KERNELS]


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_subgrid_kernels_match_plain(dev, case, S):
    """Each kernel of the chain equals its plain twin on the same rows, one
    launch each: the words, the counts and every capacity row of acc."""
    pos, status, m = make_rows(case, S)
    e = electric_force_constant(CELL)
    gpos, gstatus = pos.to(dev), status.to(dev)
    before = _launches()
    words = field.subgrid_bbox(gpos, gstatus, m, CELL, GRID)
    torch.cuda.synchronize()
    assert torch.equal(words.cpu(), field.subgrid_bbox_plain(
        pos, status, m, CELL, GRID))
    origin, fits = grid_ops.window_of(
        *field.bbox_bounds(words.tolist(), GRID), GRID, S)
    assert fits == (case != "spread")
    counts = field.subgrid_deposit(gpos, gstatus, m, CELL, GRID, origin, S)
    plain_counts = field.subgrid_deposit_plain(pos, status, m, CELL, GRID,
                                               origin, S)
    acc = field.subgrid_field_store(gpos, gstatus, m, CELL, GRID, origin, S,
                                    counts, e)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [1, 1, 1]
    assert torch.equal(counts.cpu(), plain_counts)
    want = field.subgrid_field_store_plain(pos, status, m, CELL, GRID, origin,
                                           S, plain_counts, e)
    assert acc.shape == want.shape and acc.dtype == torch.float32
    assert torch.equal(_bits(acc.cpu()), _bits(want))


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_card_chain_matches_the_cpu_grid_phase(dev, case, S):
    """grid_phase on the card equals the CPU's bit for bit on every case,
    with one readback a subgrid phase (the CPU's two) and one launch of
    each chain kernel; the box wider than the window launches the bbox
    kernel alone and takes the CPU's full-grid fallback."""
    pos, status, m = make_rows(case, S)
    cfg = SimConfig(cell_size=CELL, grid_size=GRID, bbox_subgrid=S,
                    capacity=pos.shape[0])
    st = zero_state(cfg, "cpu")._replace(pos=pos, status=status, n=m)
    grid_ops.field_counts.reset()
    cpu = grid_phase(st, cfg).acc
    cpu_counts = grid_ops.field_counts.as_dict()
    gpu_st = st._replace(**{f: getattr(st, f).to(dev) for f in
                            ("pos", "vel", "acc", "status", "id_hi", "id_lo")})
    before = _launches()
    grid_ops.field_counts.reset()
    gpu = grid_phase(gpu_st, cfg).acc
    torch.cuda.synchronize()
    assert torch.equal(_bits(gpu.cpu()), _bits(cpu))
    got = grid_ops.field_counts.as_dict()
    fits = case != "spread"
    assert got["subgrid"] == cpu_counts["subgrid"] == int(fits)
    assert got["readbacks"] == (1 if fits else 2)
    assert got["rows_fallback"] == (0 if fits else cpu_counts["rows_fallback"])
    assert [a - b for a, b in zip(_launches(), before)] == (
        [1, 1, 1] if fits else [1, 0, 0])


@pytest.mark.parametrize("subgrid", [64, 16, 0])
@pytest.mark.parametrize("hot_cell", [False, True])
def test_field_phase_on_the_card_matches_the_cpu(dev, subgrid, hot_cell):
    """grid_phase on the card equals grid_phase on the CPU (the plain
    twins) bit for bit, on every path: the subgrid (the card's kernel
    chain: one readback, no rows fallback), the window fallback (subgrid
    16 < the 62-cell seed cube), the full grid, each with and without one
    cell of 600 charges (the rows fallback of the PyTorch chain)."""
    cfg = SimConfig(init_n=60_000, capacity=65_536, grid_size=(64, 64, 64),
                    bbox_subgrid=subgrid)
    st = setup_particles(cfg, device="cpu")
    if hot_cell:
        st.pos[:600] = 32.5 * cfg.cell_size
    st.status[5:9000:9] = -2  # dead
    grid_ops.field_counts.reset()
    cpu = grid_phase(st, cfg).acc
    paths = dict(grid_ops.field_counts.paths)
    gpu_st = st._replace(**{f: getattr(st, f).to(dev) for f in
                            ("pos", "vel", "acc", "status", "id_hi", "id_lo")})
    before = field.packed_field_gather.launches
    chain_before = _launches()
    grid_ops.field_counts.reset()
    gpu = grid_phase(gpu_st, cfg).acc
    torch.cuda.synchronize()
    chain = subgrid == 64
    assert grid_ops.field_counts.paths == paths
    assert grid_ops.field_counts.rows_fallback == int(hot_cell and not chain)
    assert grid_ops.field_counts.readbacks == {64: 1, 16: 2, 0: 1}[subgrid]
    assert field.packed_field_gather.launches == before + (
        not hot_cell and not chain)
    assert [a - b for a, b in zip(_launches(), chain_before)] == (
        {64: [1, 1, 1], 16: [1, 0, 0], 0: [0, 0, 0]}[subgrid])
    assert torch.equal(_bits(gpu.cpu()), _bits(cpu))
    want = {64: "subgrid", 16: "window_fallback", 0: "full"}[subgrid]
    assert grid_ops.field_counts.last == want
    assert np.abs(cpu.numpy()).max() > 0
