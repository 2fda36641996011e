"""The set-up kernel (csrc/setup.cu, ``ops.kernels.setup.setup_seed``)
against its plain twin ``state.seed_plain``.

The card cases need a CUDA GPU and nvcc and skip elsewhere; the CPU cases
check the dispatch and the values the kernel is given.  This file imports
no JAX, so a GPU machine without JAX runs it (skipping conftest.py):

    python -m pytest tests/test_torch_setup_kernel.py -m cuda --noconftest

Tolerance: exact (every field bit for bit).  ``state.setup_particles`` on
the CPU stays bitwise the JAX package's (tests/test_torch_state.py).
"""

import numpy as np
import pytest
import torch

from particle_simulation_tpu_torch import SimConfig, rng
from particle_simulation_tpu_torch.ops.kernels import build
from particle_simulation_tpu_torch.ops.kernels import setup as setup_kernel
from particle_simulation_tpu_torch.state import (
    SimState, seed_box, seed_plain, setup_particles, thermal_vth)

WRAP = (1 << 32) - 1000  # global slot indices wrap past 2^32
BENCH = dict(init_n=1_000_000, capacity=50_000_000, grid_size=(512,) * 3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card with -m cuda)")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda", 0)


def _bits(t):
    return t.contiguous().view(torch.int64 if t.element_size() == 8
                               else torch.int32)


def _assert_kernel_equals_plain(cfg, offset, dev):
    before = setup_kernel.setup_seed.launches
    got = setup_particles(cfg, slot_offset=offset, device=dev)
    torch.cuda.synchronize()
    assert setup_kernel.setup_seed.launches == before + 1
    want = seed_plain(cfg, offset, dev)
    assert got.n == want.n == cfg.init_n
    for name in SimState._fields[:-1]:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(_bits(g), _bits(w)), name


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 5000, WRAP])
@pytest.mark.parametrize("vth", [0.0, 2e5])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_kernel_equals_plain(dev, precision, vth, offset):
    """A capacity that is no multiple of the 16-byte store (10,001 slots),
    on a clamped 16-cell box and a 256^3 grid."""
    grid = (16, 70, 100) if offset == 5000 else (256, 256, 256)
    cfg = SimConfig(init_n=3000, capacity=10_001, grid_size=grid,
                    init_vth=vth, precision=precision, seed=2718289747)
    _assert_kernel_equals_plain(cfg, offset, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(init_n=9_999, capacity=9_999, grid_size=(256,) * 3),
    dict(init_n=5, capacity=5, grid_size=(16,) * 3, init_vth=2e5),
    dict(init_n=0, capacity=77, grid_size=(32,) * 3),
    dict(init_n=1, capacity=1_000_003, grid_size=(40, 64, 512),
         precision="f64"),
], ids=["full", "tiny", "empty", "one_live"])
def test_kernel_equals_plain_at_the_edges(dev, kw):
    _assert_kernel_equals_plain(SimConfig(**kw), 3, dev)


@pytest.mark.cuda
def test_kernel_equals_plain_at_the_benchmarks_size(dev):
    """The benchmark's rows: 1e6 live of 5e7 slots on 512^3, many slots a
    thread."""
    _assert_kernel_equals_plain(SimConfig(**BENCH, seed=39587), 0, dev)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    affine = [(1.0, 0.0)] * 3
    with pytest.raises(ValueError, match="init_n"):
        setup_kernel.setup_seed(4, 5, 0, 1, affine, None, torch.float32, dev)
    with pytest.raises(ValueError, match="no set-up kernel"):
        setup_kernel.setup_seed(4, 2, 0, 1, affine, None, torch.float16,
                                dev)


def test_cpu_takes_the_plain_twin():
    """A CPU state comes from ``seed_plain`` and launches nothing."""
    cfg = SimConfig(init_n=300, capacity=1001, grid_size=(64,) * 3,
                    init_vth=2e5, seed=7)
    before = setup_kernel.setup_seed.launches
    got = setup_particles(cfg, slot_offset=11, device="cpu")
    assert setup_kernel.setup_seed.launches == before
    want = seed_plain(cfg, 11, "cpu")
    assert all(torch.equal(g, w) for g, w in zip(got[:-1], want[:-1]))
    assert got.n == 300 and (got.status[300:] == 0).all()
    with pytest.raises(ValueError, match="no set-up kernel"):
        setup_kernel.setup_seed(4, 2, 0, 1, [(1.0, 0.0)] * 3, None,
                                torch.float32, "cpu")


@pytest.mark.parametrize("grid", [(16, 16, 16), (16, 70, 100),
                                  (512, 512, 512), (61, 62, 63)])
def test_the_kernels_scale_and_shift_give_the_plain_positions(grid):
    """The kernel's float32 arithmetic, ``u01 * scale`` then ``+ shift``
    each rounded, with the (scale, shift) that ``setup_particles`` hands
    it (``rng.affine`` of ``seed_box``), gives the plain twin's positions
    bit for bit; ``seed_box`` clamps the cube to small grids."""
    cfg = SimConfig(init_n=4000, capacity=4000, grid_size=grid, seed=123)
    st = seed_plain(cfg, 0, "cpu")
    for ax in range(3):
        lo, hi = seed_box(cfg, ax)
        assert 0 <= lo < hi <= grid[ax] * cfg.cell_size
        scale, shift = rng.affine(lo, hi)
        assert (scale, shift) == (float(np.float32(hi - lo)),
                                  float(np.float32(lo)))
        b0, _ = rng.threefry2x32(st.id_hi, st.id_lo, rng.SETUP_CTR, ax)
        u01 = (b0.numpy() >> 8).astype(np.float32) * np.float32(2.0 ** -24)
        want = u01 * np.float32(scale) + np.float32(shift)
        assert want.dtype == np.float32
        np.testing.assert_array_equal(st.pos[:, ax].numpy().view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("precision,vth,want", [
    ("f32", 0.0, None), ("f32", 0.1, float(np.float32(0.1))),
    ("f64", 0.1, 0.1), ("f64", 0.0, None)])
def test_thermal_vth_is_the_plain_twins(precision, vth, want):
    cfg = SimConfig(init_n=1, capacity=2, init_vth=vth, precision=precision)
    assert thermal_vth(cfg) == want
