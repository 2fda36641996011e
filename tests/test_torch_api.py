"""Port parity: the JAX package's public names in the port's counterpart
modules (rng, ops/grid, ops/step, ops/physics, models, cross_section), each
held against the JAX function on the CPU with seeded numpy inputs.

Tolerance: exact.  ``field_grid`` and ``gather_acceleration_packed`` bit
for bit; the lookup closure on the buckets' centres, where torch's and
XLA:CPU's ``log`` cannot move a bucket (tests/test_torch_lookup.py states
the bound near the edges).
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particle_simulation_tpu as J
from particle_simulation_tpu import cross_section as jcs
from particle_simulation_tpu import rng as jrng
from particle_simulation_tpu.constants import electric_force_constant
from particle_simulation_tpu.ops import grid as jgrid
from particle_simulation_tpu.ops import physics as jphys
from particle_simulation_tpu.ops import step as jstep
from particle_simulation_tpu_torch import SimConfig, interop, models
from particle_simulation_tpu_torch import cross_section as tcs
from particle_simulation_tpu_torch import rng as trng
from particle_simulation_tpu_torch.ops import grid as tgrid
from particle_simulation_tpu_torch.ops import physics as tphys
from particle_simulation_tpu_torch.ops import step as tstep
from particle_simulation_tpu_torch.state import setup_particles

MODULES = ("rng", "ops.grid", "ops.step", "ops.physics", "models",
           "cross_section")
# TPU-only code, left out of the port on purpose (ROADMAP "Not ported"):
# the XLA:TPU scatter-floor deposit and its dispatch, and the host-chunked
# steps that work around the TPU worker fault
NOT_PORTED = {
    "ops.grid": {"deposit_sorted", "deposit_dispatch"},
    "ops.step": {"poisson_step_naive_host", "poisson_step_sync_host",
                 "poisson_step_staged_host"},
}
CELL = 1e-2


def _public(module) -> set:
    """Public names a JAX module defines or re-exports from its package
    (not the typing and stdlib names it imports)."""
    return {
        name for name, value in vars(module).items()
        if not name.startswith("_") and name != "annotations"
        and not isinstance(value, types.ModuleType)
        and getattr(value, "__module__", "particle_simulation_tpu")
        .startswith("particle_simulation_tpu")
    }


@pytest.mark.parametrize("name", MODULES)
def test_every_public_name_has_a_counterpart(name):
    jmod = importlib.import_module(f"particle_simulation_tpu.{name}")
    tmod = importlib.import_module(f"particle_simulation_tpu_torch.{name}")
    want = _public(jmod) - NOT_PORTED.get(name, set())
    assert want and not sorted(n for n in want if not hasattr(tmod, n))


@pytest.mark.parametrize("rounds", [5, 13, 20])
def test_step_uniform_bitwise(rounds):
    r = np.random.default_rng(rounds)
    hi = r.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    lo = r.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jrng.step_uniform(39587, hi, lo, 3, 7, 0.0, 100.0,
                                        rounds=rounds))
    got = trng.step_uniform(39587, torch.from_numpy(hi.view(np.int32)),
                            torch.from_numpy(lo.view(np.int32)), 3, 7, 0.0,
                            100.0, rounds=rounds)
    np.testing.assert_array_equal(want, got.numpy())


def _population(g, n, seed):
    r = np.random.default_rng(seed)
    pos = r.uniform(g * CELL * 0.3, g * CELL * 0.7, (n, 3)).astype(np.float32)
    pos[: n // 10] = r.uniform(0.0, g * CELL, (n // 10, 3)).astype(np.float32)
    weight = (r.random(n) < 0.9).astype(np.int32)
    return pos, weight


@pytest.mark.parametrize("g", [16, 32])
def test_field_grid_and_packed_gather_bitwise(g):
    grid = (g, g, g)
    pos, weight = _population(g, 20000, g)
    e = electric_force_constant(CELL)
    charge = np.array(jgrid.deposit(pos, weight, CELL, grid))
    t_charge = torch.from_numpy(charge)
    want = np.asarray(jgrid.field_grid(charge, grid, e))
    got = tgrid.field_grid(t_charge, grid, e)
    assert got.shape == (g, g, g, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))
    want = np.asarray(jgrid.gather_acceleration_packed(charge, pos, weight,
                                                       CELL, grid, e))
    got = tgrid.gather_acceleration_packed(
        t_charge, torch.from_numpy(pos), torch.from_numpy(weight), CELL, grid,
        e)
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))
    assert np.abs(want).max() > 0


def test_field_acceleration_bitwise():
    """The neighbour model's float32 dispatch: the packed diffs."""
    grid = (32, 32, 32)
    pos, weight = _population(32, 20000, 7)
    charge = np.array(jgrid.deposit(pos, weight, CELL, grid))
    jcfg = J.SimConfig(grid_size=grid)
    cfg = SimConfig(grid_size=grid)
    assert cfg.cell_size == jcfg.cell_size == CELL
    want = np.asarray(jstep.field_acceleration(charge, pos, weight, jcfg))
    got = tstep.field_acceleration(torch.from_numpy(charge),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(weight), cfg)
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))
    with pytest.raises(ValueError, match="field model"):
        tstep.field_acceleration(torch.from_numpy(charge),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(weight),
                                 cfg.replace(field_model="other"))


def test_make_table_lookup_on_bucket_centres():
    table = np.stack([np.arange(10000), -np.arange(10000)], 1)
    table = table.astype(np.float32)
    i = np.arange(10000, dtype=np.float64) + 0.5
    energy = (10.0 ** (i * 22.0 / 10000 - 6.0)).astype(np.float32)
    energy = np.concatenate([energy, np.float32([0.0, 1e-30, 1e30])])
    js, jr = jax.jit(jstep.make_table_lookup(jnp.asarray(table)))(energy)
    ts, tr = tstep.make_table_lookup(torch.from_numpy(table))(
        torch.from_numpy(energy), u=None, bits=None)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(ts.numpy()[:10000], np.arange(10000))


def test_state_particles_round_trip():
    jcfg = J.SimConfig(init_n=300, capacity=1024, grid_size=(16, 16, 16),
                       init_vth=1e6)
    js = J.setup_particles(jcfg)
    want = jstep.particles_to_state(js, jstep.state_to_particles(js))
    cfg = SimConfig(init_n=300, capacity=1024, grid_size=(16, 16, 16),
                    init_vth=1e6)
    ts = setup_particles(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ts = ts._replace(acc=torch.randn(ts.acc.shape, generator=gen))
    got = tstep.particles_to_state(
        ts, tstep.state_to_particles(ts, ts.capacity))
    for f in interop.FIELDS[:6]:
        assert torch.equal(getattr(got, f), getattr(ts, f)), f
    assert got.n == ts.n
    # the seeded state itself is the JAX package's
    np.testing.assert_array_equal(np.asarray(want.id_lo).view(np.int32),
                                  got.id_lo.numpy())
    np.testing.assert_array_equal(np.asarray(want.pos).view(np.int32),
                                  got.pos.numpy().view(np.int32))


@pytest.mark.parametrize("name", ["leapfrog", "boris"])
def test_integrators_match_jax(name):
    """Each integrator of INTEGRATORS against the JAX one, jitted as the
    JAX engines run it (XLA contracts its multiply-adds there)."""
    assert set(tphys.INTEGRATORS) == set(jphys.INTEGRATORS)
    r = np.random.default_rng(3)
    f = [r.uniform(0.1, 0.9, 2048).astype(np.float32) for _ in range(3)]
    f += [r.normal(0, 1e6, 2048).astype(np.float32) for _ in range(3)]
    f += [r.normal(0, 1e16, 2048).astype(np.float32) for _ in range(3)]
    words = [np.zeros(2048, np.int32)] * 3
    dt = 1e-12
    jp = jphys.Particles(*f, *words)
    want = jax.jit(lambda p: jphys.INTEGRATORS[name](p, dt))(jp)
    got = tphys.INTEGRATORS[name](
        tphys.Particles(*(torch.from_numpy(x) for x in f + words)), dt, None)
    for a, b in zip(want[:6], got[:6]):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))


def test_model_names_and_re_exports():
    jmodels = importlib.import_module("particle_simulation_tpu.models")
    assert models.COLLISION_MODELS == jmodels.COLLISION_MODELS
    assert models.FIELD_MODELS == jmodels.FIELD_MODELS
    assert models.INTEGRATORS is tphys.INTEGRATORS
    assert (models.gather_acceleration_packed
            is tgrid.gather_acceleration_packed)
    assert models.deposit is tgrid.deposit


def test_ensure_bundled_tables_writes_the_jax_files(tmp_path):
    sine, const = tcs.ensure_bundled_tables(str(tmp_path / "data"))
    for ours, theirs in zip((sine, const), jcs.bundled_paths()):
        np.testing.assert_array_equal(tcs.load_table(ours, "cpu").numpy(),
                                      np.asarray(jcs.load_table(theirs)))
    want = tmp_path / "jax.txt"
    jcs.write_table(str(want), jcs.generate_table())
    assert open(sine, "rb").read() == want.read_bytes()
    # an existing table is left as it is
    with open(const, "w") as f:
        f.write("kept\n")
    tcs.ensure_bundled_tables(str(tmp_path / "data"))
    assert open(const).read() == "kept\n"
