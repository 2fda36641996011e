"""The field-gather CUDA kernel (csrc/field.cu) against its plain PyTorch
twins, on the card.

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
from particle_simulation_tpu_torch.state import setup_particles

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


@pytest.mark.parametrize("subgrid", [64, 16, 0])
@pytest.mark.parametrize("hot_cell", [False, True])
def test_field_phase_on_the_card_matches_the_cpu(dev, subgrid, hot_cell):
    """grid_phase on the card (the kernel) equals grid_phase on the CPU
    (the plain twin) bit for bit, on every path: the subgrid, the window
    fallback (subgrid 16 < the 62-cell seed cube), the full grid, each with
    and without one cell of 600 charges (the rows fallback)."""
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
    grid_ops.field_counts.reset()
    gpu = grid_phase(gpu_st, cfg).acc
    torch.cuda.synchronize()
    assert grid_ops.field_counts.paths == paths
    assert grid_ops.field_counts.rows_fallback == int(hot_cell)
    assert field.packed_field_gather.launches == before + (not hot_cell)
    assert torch.equal(_bits(gpu.cpu()), _bits(cpu))
    want = {64: "subgrid", 16: "window_fallback", 0: "full"}[subgrid]
    assert grid_ops.field_counts.last == want
    assert np.abs(cpu.numpy()).max() > 0
