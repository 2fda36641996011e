"""Port parity: the field phase (ops/grid.py bbox subgrid and packed-diff
paths, ops/step.grid_phase) and the field-gather kernel's plain twins
(ops/kernels/field.py) against the JAX package, on the CPU.  Tolerance:
bitwise (the field is float32(int diff) * float32(e_const) on every path).

The cases mirror tests/test_grid.py's bbox tests at subgrid 16 on a 64^3
grid, and each also checks which path the port took.  The banded gather's
plain twin is held against the TPU kernel of
scripts/microbench_fieldgather.py, run through ``pallas_call`` in
interpret mode with the script's BlockSpecs."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import particle_simulation_tpu as J
from particle_simulation_tpu.constants import electric_force_constant
from particle_simulation_tpu.ops import grid as jgrid
from particle_simulation_tpu.ops import step as jstep
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch.config import check_supported
from particle_simulation_tpu_torch.ops import grid as tgrid
from particle_simulation_tpu_torch.ops.kernels import field
from particle_simulation_tpu_torch.ops.step import grid_phase
from particle_simulation_tpu_torch.probes import microbench_fieldgather as probe
from particle_simulation_tpu_torch.state import setup_particles

CELL = 0.5
GRID = (64, 64, 64)
E = electric_force_constant(CELL)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cube(rng, lo_cell, hi_cell, n):
    """n positions uniform in cells [lo_cell, hi_cell) of every axis, with
    one particle in the lowest and one in the highest cell."""
    pos = rng.uniform(lo_cell * CELL, hi_cell * CELL * 0.9999, (n, 3))
    pos[0] = (lo_cell + 0.5) * CELL
    pos[1] = (hi_cell - 0.5) * CELL
    return pos.astype(np.float32)


def _both(pos, weight, subgrid=16):
    """(JAX, port) bbox_field_acceleration, and the port's path."""
    want = np.asarray(jgrid.bbox_field_acceleration(
        jnp.asarray(pos), jnp.asarray(weight), CELL, GRID, E, subgrid=subgrid))
    tgrid.field_counts.reset()
    got = tgrid.bbox_field_acceleration(
        torch.from_numpy(pos), torch.from_numpy(weight), CELL, GRID, E,
        subgrid=subgrid)
    return want, got.numpy(), tgrid.field_counts


def _assert_bitwise(want, got):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_bbox_subgrid_path_clustered():
    rng = np.random.default_rng(4)
    pos = _cube(rng, 20, 30, 2000)
    weight = (rng.uniform(size=2000) < 0.9).astype(np.int32)
    weight[:2] = 1
    want, got, counts = _both(pos, weight)
    _assert_bitwise(want, got)
    assert counts.last == "subgrid" and counts.readbacks == 2
    assert counts.rows_fallback == 0 and np.abs(got).max() > 0


def test_bbox_window_fallback_spread():
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 64 * CELL * 0.999, (2000, 3)).astype(np.float32)
    want, got, counts = _both(pos, np.ones(2000, np.int32))
    _assert_bitwise(want, got)
    assert counts.last == "window_fallback" and counts.readbacks == 2


# (lo_cell, hi_cell, path): the JAX boundary cases, and the window's edges:
# ext = S-2 fits; ext = S-1 fits only at the global edge
@pytest.mark.parametrize("lo_cell,hi_cell,path", [
    (0, 10, "subgrid"), (54, 64, "subgrid"), (0, 14, "subgrid"),
    (0, 15, "subgrid"), (0, 16, "window_fallback"), (1, 15, "subgrid"),
    (49, 64, "subgrid"), (48, 64, "window_fallback"),
    (20, 34, "subgrid"), (20, 35, "window_fallback"),
])
def test_bbox_window_edges_and_global_boundaries(lo_cell, hi_cell, path):
    rng = np.random.default_rng(6 + lo_cell + hi_cell)
    pos = _cube(rng, lo_cell, hi_cell, 800)
    want, got, counts = _both(pos, np.ones(800, np.int32))
    _assert_bitwise(want, got)
    assert counts.last == path


@pytest.mark.parametrize("lo_cell,hi_cell,path", [
    (20, 30, "subgrid"), (0, 64, "window_fallback"),
])
def test_bbox_rows_fallback_when_a_diff_exceeds_10_bits(lo_cell, hi_cell, path):
    """One cell holds 600 charges: |diff| = 600 > 511 around it, so both
    the subgrid and the full-grid path gather float32 rows."""
    rng = np.random.default_rng(9)
    pos = _cube(rng, lo_cell, hi_cell, 1600)
    pos[2:602] = (25.5 * CELL, 25.5 * CELL, 25.5 * CELL)
    pos[602:610] = (26.5 * CELL, 25.5 * CELL, 25.5 * CELL)  # a neighbour
    weight = np.ones(1600, np.int32)
    weight[1000:1100] = 0
    want, got, counts = _both(pos, weight)
    _assert_bitwise(want, got)
    assert counts.last == path and counts.rows_fallback == 1
    assert np.abs(got).max() > 511 * np.float32(E)


def test_bbox_empty_population():
    pos = np.zeros((16, 3), np.float32)
    want, got, counts = _both(pos, np.zeros(16, np.int32))
    _assert_bitwise(want, got)
    assert (got == 0).all() and counts.last == "subgrid"


def test_live_bbox_matches_jax():
    rng = np.random.default_rng(10)
    idx = rng.integers(0, 64, (500, 3)).astype(np.int32)
    for weight in ((rng.uniform(size=500) < 0.5).astype(np.int32),
                   np.zeros(500, np.int32)):
        jlo, jhi = jgrid.live_bbox(jnp.asarray(idx), jnp.asarray(weight), GRID)
        tlo, thi = tgrid.live_bbox(torch.from_numpy(idx),
                                   torch.from_numpy(weight), GRID)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def test_pack_unpack_roundtrip_and_jax_packing():
    rng = np.random.default_rng(11)
    d = [rng.integers(-511, 512, 4096).astype(np.int32) for _ in range(3)]
    jb = jgrid._PACK_BIAS
    want = ((d[0] + jb) << 20) | ((d[1] + jb) << 10) | (d[2] + jb)
    packed = tgrid.pack_diffs(*map(torch.from_numpy, d))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(field.unpack_diffs(packed).numpy(),
                                  np.stack(d, 1))


@pytest.mark.parametrize("big", [0, 1000])
def test_full_grid_packdiff_matches_jax(big):
    """The full-grid path, packed and (one cell + 1000) rows fallback."""
    rng = np.random.default_rng(12)
    grid = (16, 16, 16)
    pos = rng.uniform(0, 16 * CELL * 0.999, (3000, 3)).astype(np.float32)
    weight = (rng.uniform(size=3000) < 0.9).astype(np.int32)
    charge = np.array(jgrid.deposit(pos, weight, CELL, grid))
    charge[jgrid.flatten_cells(4, 4, 4, grid)] += big
    want = np.asarray(jgrid.gather_acceleration_packdiff(
        jnp.asarray(charge), jnp.asarray(pos), jnp.asarray(weight), CELL,
        grid, E))
    tgrid.field_counts.reset()
    got = tgrid.gather_acceleration_packdiff(
        torch.from_numpy(charge), torch.from_numpy(pos),
        torch.from_numpy(weight), CELL, grid, E)
    _assert_bitwise(want, got.numpy())
    assert tgrid.field_counts.rows_fallback == (1 if big else 0)


@pytest.mark.parametrize("subgrid", [64, 0])
@pytest.mark.parametrize("init_n,capacity", [(300, 1024), (0, 256)])
def test_grid_phase_matches_jax(subgrid, init_n, capacity):
    """JAX step.grid_phase against the port's on one state with dead and
    empty slots, at bbox_subgrid 64 and 0 (the full grid)."""
    kw = dict(init_n=init_n, capacity=capacity, grid_size=(32, 32, 32),
              bbox_subgrid=subgrid)
    jstate = J.setup_particles(J.SimConfig(**kw))
    arrays = {f: np.asarray(getattr(jstate, f)) for f in interop.FIELDS}
    arrays["status"] = arrays["status"].copy()
    arrays["status"][: init_n // 3] = -2  # dead
    jstate = jstate._replace(status=jnp.asarray(arrays["status"]))
    want = np.asarray(jstep._sync_grid_jit(jstate, J.SimConfig(**kw)).acc)
    tgrid.field_counts.reset()
    cfg = SimConfig(**kw)
    got = grid_phase(interop.state_from_numpy(arrays, "cpu"), cfg).acc.numpy()
    _assert_bitwise(want, got)
    assert tgrid.field_counts.last == ("subgrid" if subgrid else "full")
    assert tgrid.field_counts.readbacks == (2 if subgrid else 1)
    if init_n:
        assert np.abs(got).max() > 0


@pytest.mark.parametrize("bad", [-8, 4, 12, 100])
def test_check_supported_rejects_bad_subgrid(bad):
    with pytest.raises(ValueError, match="bbox_subgrid"):
        check_supported(SimConfig(bbox_subgrid=bad))
    for ok in (0, 8, 16, 64):
        check_supported(SimConfig(bbox_subgrid=ok))


def _load_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_banded_gather_plain_matches_pallas_kernel():
    """The TPU kernel in interpret mode at R=64, SUB=8 on sorted ids, with
    the script's BlockSpecs (table whole in VMEM, (SUB, 128) index tiles)."""
    script = _load_script("microbench_fieldgather")
    R, L, SUB, n = 64, 128, 8, 4096
    rng = np.random.default_rng(13)
    table = rng.integers(0, 1 << 30, (R, L)).astype(np.int32)
    ids = np.sort(rng.integers(0, R * L, n)).astype(np.int32)
    rows, lanes = (ids >> 7).reshape(-1, L), (ids & 127).reshape(-1, L)
    want = pl.pallas_call(
        script.banded_gather_kernel,
        grid=(rows.shape[0] // SUB,),
        in_specs=[
            pl.BlockSpec((R, L), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((SUB, L), lambda i: (i, 0)),
            pl.BlockSpec((SUB, L), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((SUB, L), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(rows.shape, jnp.int32),
        interpret=True,
    )(table, rows, lanes)
    got = field.banded_gather_plain(*map(torch.from_numpy, (table, rows, lanes)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().reshape(-1), table.reshape(-1)[ids])


def test_cpu_wrappers_take_the_plain_twins():
    rng = np.random.default_rng(14)
    table = torch.from_numpy(rng.integers(0, 1 << 30, (16, 128)).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, 16 * 128, 1024).astype(np.int32))
    rows, lanes = (ids >> 7).reshape(-1, 128), (ids & 127).reshape(-1, 128)
    before = (field.banded_gather.launches, field.packed_field_gather.launches)
    assert torch.equal(field.banded_gather(table, rows, lanes),
                       table.reshape(-1)[ids.long()].reshape(-1, 128))
    flat = ids.clone()
    flat[::7] = -1
    weight = (flat >= 0).to(torch.int32)
    weight[1::5] = 0
    packed = table.reshape(-1) & ((1 << 30) - 1)
    got = field.packed_field_gather(packed, flat, weight, E)
    assert got.shape == (1024, 3) and got.dtype == torch.float32
    assert torch.equal(got, field.packed_field_gather_plain(packed, flat, weight, E))
    assert (got[weight == 0] == 0).all()
    assert before == (field.banded_gather.launches,
                      field.packed_field_gather.launches)


def test_wrappers_reject_bad_shapes():
    t = torch.zeros((4, 64), dtype=torch.int32)
    idx = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="table"):
        field.banded_gather(t, idx, idx)
    with pytest.raises(ValueError, match="one shape"):
        field.banded_gather(torch.zeros((4, 128), dtype=torch.int32), idx,
                            idx[:, :64])
    with pytest.raises(ValueError, match="flat"):
        field.packed_field_gather(t, idx[0], idx[0, :5], E)


def test_probe_inputs_and_band_stats():
    """The probe's inputs (seeded Gaussian ball in 64^3) and its band
    statistics, at a small N on the CPU."""
    a = probe.make_inputs(n=128 * 256, seed=0, device="cpu")
    b = probe.make_inputs(n=128 * 256, seed=0, device="cpu")
    assert torch.equal(a.ids, b.ids) and torch.equal(a.table, b.table)
    assert a.table.shape == (probe.R, probe.L) and a.ids.dtype == torch.int32
    assert 0 <= int(a.ids.min()) and int(a.ids.max()) < probe.R * probe.L
    assert torch.equal(a.ids_sorted, torch.sort(a.ids).values)
    mean, mx = probe.band_stats(a.ids_sorted)
    rows = (a.ids_sorted.numpy() >> 7).reshape(-1, probe.SUB, probe.L)
    span = rows.max(axis=(1, 2)) - rows.min(axis=(1, 2)) + 1
    assert mean == pytest.approx(span.mean()) and mx == span.max()


def test_main_path_seed_cube_takes_the_subgrid():
    """The seed cube of a 256^3 grid (cells 98..159) fits the 64^3 window:
    step 0 of the main path takes the subgrid path."""
    cfg = SimConfig(init_n=2000, capacity=4096, grid_size=(256, 256, 256))
    tgrid.field_counts.reset()
    st = grid_phase(setup_particles(cfg, device="cpu"), cfg)
    assert tgrid.field_counts.last == "subgrid"
    assert st.acc.shape == (4096, 3) and bool(torch.isfinite(st.acc).all())
