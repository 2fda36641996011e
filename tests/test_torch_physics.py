"""Port parity: ops/physics.update_particles against the JAX package's,
jitted as its naive cadence calls it (schedulers._one_step): the kick from
make_kick and the table read through step.make_table_lookup.  Bitwise on
every output field and on ``spawn``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_simulation_tpu.cross_section import bundled_paths, load_table
from particle_simulation_tpu.ops import physics as jphys
from particle_simulation_tpu.ops.step import make_table_lookup
from particle_simulation_tpu_torch.ops import physics as tphys

N = 20000
DT = 1e-12
SIZE = (0.16, 0.16, 0.16)
SEED = 39587


def _lanes(seed):
    """Random lanes: positions inside, near and outside the domain edges,
    velocities and accelerations large enough that the drift changes
    positions in their last bits, statuses of every kind."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    pos = r.uniform(-1e-5, 0.16 + 1e-5, (3, N)).astype(f32)
    pos[:, : N // 2] = r.uniform(0.0, 1e-5, (3, N // 2)).astype(f32)
    vel = (r.standard_normal((3, N)) * 10.0 ** r.uniform(3, 8, N)).astype(f32)
    acc = (r.standard_normal((3, N)) * 10.0 ** r.uniform(14, 19, N)).astype(f32)
    status = r.choice(np.array([-1, -2, 0, 1, 5], np.int32), N)
    ids = r.integers(0, 1 << 32, (2, N), dtype=np.uint64).astype(np.uint32)
    return pos, vel, acc, status, ids


def _jax_step(fields, active, t, table, mode):
    p = jphys.Particles(*fields)
    kick = jphys.make_kick("leapfrog", (p.ax, p.ay, p.az), DT, jnp.float32)
    return jphys.update_particles(
        p, active=active, t=t, poisson_step=jnp.uint32(3), dt=DT,
        sim_size=SIZE, split_chance=None, remove_chance=None, seed=SEED,
        table_lookup=make_table_lookup(table), rng_rounds=13, rng_mode=mode,
        kick=kick,
    )


@pytest.mark.parametrize("mode", ["block2", "perstep"])
@pytest.mark.parametrize("t", [1, 4, 7])
def test_update_particles_bitwise(mode, t):
    pos, vel, acc, status, ids = _lanes(t)
    table = load_table(bundled_paths()[1])
    active = (status == -1) | ((status > 0) & (t > status))
    jfields = [*pos, *vel, *acc, status, ids[0], ids[1]]
    jres = jax.jit(_jax_step, static_argnums=(2, 4))(
        [jnp.asarray(x) for x in jfields], jnp.asarray(active), t, table, mode,
    )
    tfields = [torch.from_numpy(np.ascontiguousarray(x)) for x in
               (*pos, *vel, *acc, status)]
    tfields += [torch.from_numpy(ids[k].view(np.int32).copy()) for k in (0, 1)]
    tres = tphys.update_particles(
        tphys.Particles(*tfields), active=torch.from_numpy(active), t=t,
        poisson_step=3, dt=DT, sim_size=SIZE, seed=SEED,
        table=torch.from_numpy(np.array(table)), rng_rounds=13,
        rng_mode=mode,
    )
    np.testing.assert_array_equal(np.asarray(jres.spawn), tres.spawn.numpy())
    assert tres.spawn.any() and (tres.particles.status == -2).any()
    spawn = tres.spawn.numpy()
    for group, jg, tg in (("parent", jres.particles, tres.particles),
                          ("child", jres.child, tres.child)):
        for name, a, b in zip(jphys.Particles._fields, jg, tg):
            a = np.asarray(a)
            b = b.numpy()
            if name in ("id_hi", "id_lo"):
                b = b.view(np.uint32)
            if group == "child":  # child fields are defined on spawn lanes
                a, b = a[spawn], b[spawn]
            np.testing.assert_array_equal(a, b, err_msg=f"{group}.{name}")


def test_collision_energy_matches_fused_xla():
    r = np.random.default_rng(9)
    v = (r.standard_normal((3, 100000)) * 1e6).astype(np.float32)
    zeros = np.zeros((3, 100000), np.float32)
    p = jphys.Particles(*zeros, *v, *zeros, None, None, None)
    want = np.asarray(jax.jit(jphys.collision_energy)(p))
    got = tphys.collision_energy(tphys.Particles(
        None, None, None, *(torch.from_numpy(x) for x in v),
        *([None] * 6))).numpy()
    np.testing.assert_array_equal(want, got)


def test_out_of_bounds_forms_agree():
    r = np.random.default_rng(10)
    pos = r.uniform(-0.01, 0.17, (3, 50000)).astype(np.float32)
    t = [torch.from_numpy(x) for x in pos]
    p = tphys.Particles(*t, *([None] * 9))
    for size in (SIZE, (0.16, 0.1, 0.05)):
        jp = jphys.Particles(*pos, *([None] * 9))
        np.testing.assert_array_equal(
            np.asarray(jphys.out_of_bounds(jp, size)),
            tphys.out_of_bounds(p, size).numpy(),
        )
