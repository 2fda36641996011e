"""Port parity for the model menu: the cross-section tables, the thermal
start, the boris push, the periodic wrap and the isotropic collision model
against the JAX package's functions on the same numpy inputs, and whole
Poisson steps of the port's plain ``dynamic`` against JAX ``sync`` (XLA)
under each model and under the magnetized-argon combination.

Tolerances, and why:
* the tables: bitwise (numpy on both sides);
* the push (boris at B = 0 and with a field), the wrap, every decision
  (split, death, genealogy ids) and every counter: exact.  The port writes
  XLA:CPU's contractions site for site (fma.py);
* the isotropic child's velocity: ``rtol=2e-6``, the JAX package's own
  bound between its engines (tests/test_models.py).  XLA:CPU's ``cos`` and
  ``sin`` are one ulp off the correctly rounded value, which the port
  takes, on about 1.3% of arguments;
* the thermal start: at most ``GAUSS_MAX_ULPS`` ulps on at most
  ``GAUSS_MAX_SHARE`` of the values, through XLA:CPU's ``log`` and ``cos``
  (measured: below).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particle_simulation_tpu as J
from particle_simulation_tpu import cross_section as jcs
from particle_simulation_tpu import rng as jrng
from particle_simulation_tpu.ops import physics as jphys
from particle_simulation_tpu.ops.step import make_table_lookup
from particle_simulation_tpu.ops.step import poisson_step as j_step
from particle_simulation_tpu_torch import SimConfig, cross_section, interop
from particle_simulation_tpu_torch import rng as trng
from particle_simulation_tpu_torch.config import check_supported
from particle_simulation_tpu_torch.ops import physics as tphys
from particle_simulation_tpu_torch.ops.step import poisson_step
from particle_simulation_tpu_torch.runtime import multiset_with_ids
from particle_simulation_tpu_torch.state import setup_particles

DT = 1e-12
SIZE = (0.16, 0.16, 0.16)
SEED = 39587
KEYS = ("n", "added", "removed", "overflow", "pushes_lo", "pushes_hi")
RTOL = 2e-6
# the thermal start against XLA:CPU, measured on 3 x 10^6 slots: 7.6% of
# the values differ (6.8% by 1 ulp, 0.8% by 2, 0.01% by 3, none by more),
# through XLA's log, one ulp off on about 14% of its arguments, and its
# cos, on about 1.3%
GAUSS_MAX_ULPS = 3
GAUSS_MAX_SHARE = 0.1

ARGON = dict(gas_density=1e23, dt=1e-12)
SMALL = dict(init_n=200, capacity=8192, grid_size=(16, 16, 16),
             poisson_timestep=6)
MAGNETIZED_ARGON = dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                        collision_model="isotropic", boundary="periodic",
                        init_vth=2.0e6)
MODELS = {
    "boris": (SMALL, dict(integrator="boris"), "const"),
    "boris_field": (SMALL, dict(integrator="boris",
                                b_field=(3e11, -5e11, 7e11)), "const"),
    # a step of 1e-9 s at 1e6 m/s moves 0.1 cell: lanes cross the faces
    "periodic": (SMALL, dict(boundary="periodic", mobility_dt=1e-9,
                             init_vth=1e6), "const"),
    "isotropic": (SMALL, dict(collision_model="isotropic"), "const"),
    "thermal": (SMALL, dict(init_vth=2e6), "const"),
    "magnetized_argon": (dict(init_n=2000, capacity=16384,
                              grid_size=(32, 32, 32), poisson_timestep=20),
                         MAGNETIZED_ARGON, "argon"),
}
STEPS = 3


def _table(name):
    if name == "argon":
        return cross_section.argon_like_table(**ARGON)
    return np.asarray(jcs.load_table(jcs.bundled_paths()[1]))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---- the tables -----------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), ARGON, dict(gas_density=3e21,
                                                    dt=2e-10, n_steps=512)])
def test_argon_like_table_bitwise(kw):
    want = jcs.argon_like_table(**kw)
    got = cross_section.argon_like_table(**kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_physical_table_bitwise():
    def split(e):
        return 1e-20 * np.sqrt(e) / (1.0 + e / 1e14)

    def remove(e):
        return np.full_like(e, 3e-22)

    want = jcs.physical_table(split, remove, 5e22, 1e-11)
    got = cross_section.physical_table(split, remove, 5e22, 1e-11)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[:, 0] > 0).any() and (got[:, 1] > 0).all()


def test_write_table_matches_and_loads(tmp_path):
    table = cross_section.argon_like_table(**ARGON)
    cross_section.write_table(str(tmp_path / "port.txt"), table)
    jcs.write_table(str(tmp_path / "jax.txt"), table)
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    loaded = cross_section.load_table(str(tmp_path / "port.txt"), "cpu")
    np.testing.assert_array_equal(loaded.numpy(), table)


# ---- the thermal start ----------------------------------------------------

def test_setup_gaussian_within_stated_ulps():
    slots = np.arange(20000, dtype=np.uint32)
    jhi, jlo = jrng.initial_ids(SEED, jnp.asarray(slots))
    thi, tlo = trng.initial_ids(SEED, torch.from_numpy(slots.astype(np.int64)))
    differ = 0
    for axis in range(3):
        want = np.asarray(jrng.setup_gaussian(jhi, jlo, axis))
        got = trng.setup_gaussian(thi, tlo, axis).numpy()
        ulps = _ulps(want, got)
        assert ulps.max() <= GAUSS_MAX_ULPS, ulps.max()
        differ += int((ulps > 0).sum())
    assert differ <= GAUSS_MAX_SHARE * 3 * len(slots), differ


def test_setup_particles_thermal_start():
    kw = dict(init_n=3000, capacity=4096, grid_size=(32, 32, 32),
              init_vth=2e6)
    want = J.setup_particles(J.SimConfig(**kw))
    got = setup_particles(SimConfig(**kw), device="cpu")
    np.testing.assert_array_equal(np.asarray(want.pos), got.pos.numpy())
    np.testing.assert_array_equal(np.asarray(want.status),
                                  got.status.numpy())
    ulps = _ulps(np.asarray(want.vel), got.vel.numpy())
    assert ulps.max() <= GAUSS_MAX_ULPS
    assert (ulps > 0).mean() <= GAUSS_MAX_SHARE
    vel = got.vel.numpy()
    assert (vel[3000:] == 0).all()
    # the components are init_vth * N(0, 1)
    assert abs(vel[:3000].std() / 2e6 - 1.0) < 0.05
    assert abs(vel[:3000].mean() / 2e6) < 0.05


# ---- the push, the wrap, the isotropic model -------------------------------

def test_make_kick_matches_jax():
    r = np.random.default_rng(4)
    acc = [r.standard_normal(64).astype(np.float32) * 1e16 for _ in range(3)]
    for integrator, b in (("leapfrog", None), ("boris", None),
                          ("boris", (0.0, 0.0, 0.0)),
                          ("boris", (0.0, 0.0, -1.76e9)),
                          ("boris", (3e11, -5e11, 7e11))):
        want = jphys.make_kick(integrator, tuple(map(jnp.asarray, acc)), DT,
                               jnp.float32, b_field=b)
        got = tphys.make_kick(integrator, tuple(map(torch.from_numpy, acc)),
                              DT, b_field=b)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            g = g.numpy() if isinstance(g, torch.Tensor) else np.float32(g)
            np.testing.assert_array_equal(np.asarray(w, np.float32), g)


def _lanes(seed, n=20000):
    """Random lanes: positions inside, near and outside the domain edges,
    velocities and accelerations large enough that a step changes
    positions in their last bits, statuses of every kind."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    pos = r.uniform(-1e-5, 0.16 + 1e-5, (3, n)).astype(f32)
    pos[:, : n // 2] = r.uniform(0.0, 1e-5, (3, n // 2)).astype(f32)
    vel = (r.standard_normal((3, n)) * 10.0 ** r.uniform(3, 8, n)).astype(f32)
    acc = (r.standard_normal((3, n))
           * 10.0 ** r.uniform(14, 19, n)).astype(f32)
    status = r.choice(np.array([-1, -2, 0, 1, 5], np.int32), n)
    ids = r.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(np.uint32)
    return pos, vel, acc, status, ids


@functools.partial(jax.jit, static_argnums=(2, 4, 5, 6, 7))
def _jax_update(fields, active, t, table, integrator, collision, boundary,
                b_field):
    """The JAX package's update_particles as its cadences call it
    (schedulers._one_step), jitted."""
    p = jphys.Particles(*fields)
    kick = jphys.make_kick(integrator, (p.ax, p.ay, p.az), DT, jnp.float32,
                           b_field=b_field)
    return jphys.update_particles(
        p, active=active, t=t, poisson_step=jnp.uint32(3), dt=DT,
        sim_size=SIZE, split_chance=None, remove_chance=None, seed=SEED,
        table_lookup=make_table_lookup(table), rng_rounds=13,
        rng_mode="block2", integrator=integrator,
        collision_model=collision, kick=kick, boundary=boundary,
    )


UPDATE_MODELS = [
    ("boris", "reverse", "absorb", (0.0, 0.0, 0.0)),
    ("boris", "reverse", "absorb", (0.0, 0.0, -1.76e9)),
    ("boris", "reverse", "absorb", (3e11, -5e11, 7e11)),
    ("leapfrog", "reverse", "periodic", (0.0, 0.0, 0.0)),
    ("leapfrog", "isotropic", "absorb", (0.0, 0.0, 0.0)),
    ("boris", "isotropic", "periodic", (0.0, 0.0, -1.76e9)),
]


@pytest.mark.parametrize("model", UPDATE_MODELS, ids=lambda m: "-".join(
    str(x) for x in m[:3]) + ("-field" if any(m[3]) else ""))
def test_update_particles_models(model):
    integrator, collision, boundary, b_field = model
    t = 5
    pos, vel, acc, status, ids = _lanes(t)
    table = jcs.load_table(jcs.bundled_paths()[1])
    active = (status == -1) | ((status > 0) & (t > status))
    jres = _jax_update(
        [jnp.asarray(x) for x in (*pos, *vel, *acc, status, *ids)],
        jnp.asarray(active), t, table, *model)
    tf = [torch.from_numpy(np.ascontiguousarray(x))
          for x in (*pos, *vel, *acc, status)]
    tf += [torch.from_numpy(ids[k].view(np.int32).copy()) for k in (0, 1)]
    tres = tphys.update_particles(
        tphys.Particles(*tf), active=torch.from_numpy(active), t=t,
        poisson_step=3, dt=DT, sim_size=SIZE, seed=SEED,
        table=torch.from_numpy(np.array(table)), rng_rounds=13,
        rng_mode="block2", integrator=integrator, collision_model=collision,
        boundary=boundary, b_field=b_field,
    )
    spawn = tres.spawn.numpy()
    np.testing.assert_array_equal(np.asarray(jres.spawn), spawn)
    assert spawn.any()
    if boundary == "absorb":
        assert (tres.particles.status == -2).any()
    for group, jg, tg in (("parent", jres.particles, tres.particles),
                          ("child", jres.child, tres.child)):
        for name, a, b in zip(jphys.Particles._fields, jg, tg):
            a = np.asarray(a)
            b = b.numpy()
            if name in ("id_hi", "id_lo"):
                b = b.view(np.uint32)
            if group == "child":
                a, b = a[spawn], b[spawn]
            if group == "child" and collision == "isotropic" and name in (
                    "vx", "vy", "vz"):
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=0,
                                           err_msg=f"{group}.{name}")
                assert (a != b).mean() < 0.03  # the 1-ulp cos/sin share
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{group}.{name}")


def test_isotropic_child_speed_and_direction():
    """The child leaves at the lane's speed (to float32 rounding), in
    directions that cover the sphere evenly; the lane keeps its
    velocity."""
    pos, vel, acc, status, ids = _lanes(11)
    tf = [torch.from_numpy(np.ascontiguousarray(x))
          for x in (*pos, *vel, *acc, np.full_like(status, -1))]
    tf += [torch.from_numpy(ids[k].view(np.int32).copy()) for k in (0, 1)]
    table = torch.full((10000, 2), 100.0)  # every lane splits
    p = tphys.Particles(*tf)
    res = tphys.update_particles(
        p, active=torch.ones(len(status), dtype=torch.bool), t=1,
        poisson_step=0, dt=DT, sim_size=(1.0, 1.0, 1.0), seed=SEED,
        table=table, rng_rounds=13, collision_model="isotropic",
        boundary="periodic")
    moved = tphys.leapfrog(p, DT)
    cv = torch.stack([res.child.vx, res.child.vy, res.child.vz], 1).double()
    mv = torch.stack([moved.vx, moved.vy, moved.vz], 1).double()
    np.testing.assert_allclose(cv.norm(dim=1).numpy(), mv.norm(dim=1).numpy(),
                               rtol=1e-6)
    unit = (cv / cv.norm(dim=1, keepdim=True)).numpy()
    assert np.abs(unit.mean(0)).max() < 0.03  # no preferred direction
    assert np.all(np.abs((unit ** 2).mean(0) - 1 / 3) < 0.02)
    np.testing.assert_array_equal(res.particles.vx.numpy(), moved.vx.numpy())


def test_wrap_periodic_matches_jax():
    size = (5.12, 5.12, 5.12)
    edge = float(np.nextafter(np.float32(5.12), np.float32(0)))
    vals = np.asarray([-1e-8, -0.5, 0.0, 2.0, 5.12, 5.12 + 0.25, 17.0, -11.0,
                       edge, -1e-30, -5.12, 10.24], np.float32)
    z = np.zeros_like(vals)
    jp = jphys.Particles(*(jnp.asarray(x) for x in (vals, z, vals[::-1])),
                         *([None] * 9))
    want = jax.jit(jphys.wrap_periodic, static_argnums=1)(jp, size)
    tp = tphys.Particles(*(torch.from_numpy(np.ascontiguousarray(x))
                           for x in (vals, z, vals[::-1])), *([None] * 9))
    got = tphys.wrap_periodic(tp, size)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    x = got.px.numpy().astype(np.float64)
    assert np.all(x >= 0) and np.all(x < 5.12)
    np.testing.assert_array_equal(x[2:4], [0.0, 2.0])
    np.testing.assert_allclose(x[5], 0.25, rtol=1e-5)
    np.testing.assert_allclose(x[1], 5.12 - 0.5, rtol=1e-6)
    assert x[0] == x[9] == edge  # tiny negatives wrap to the edge


def test_kernel_arguments_carry_the_models():
    """What the CUDA engines receive (engine.phys_args): model 0 for the
    reference, the bits of each selection, and the rotation's constants
    (``rotation``, bitwise JAX's make_kick) only with a field."""
    from particle_simulation_tpu_torch.ops.kernels import engine

    def args(**kw):
        return engine.phys_args(SimConfig(**kw), 0, 10)

    bits = engine.MODEL_BITS
    assert args()[13:] == (0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    assert args(init_vth=2e6, field_model="fft")[13] == 0
    assert args(b_field=(0.0, 0.0, 1e9))[13] == 0  # leapfrog ignores B
    assert args(integrator="boris")[13] == bits["boris"]
    full = args(**MAGNETIZED_ARGON)
    assert full[13] == sum(bits.values())
    t, s = tphys.rotation(MAGNETIZED_ARGON["b_field"], DT)
    assert full[14:] == (*t, *s)
    kick = jphys.make_kick("boris", (jnp.zeros(1),) * 3, DT, jnp.float32,
                           b_field=MAGNETIZED_ARGON["b_field"])
    np.testing.assert_array_equal(np.asarray(kick[3:], np.float32),
                                  np.asarray(full[14:], np.float32))


# ---- whole Poisson steps against JAX sync ---------------------------------

def _by_ids(state):
    """The live rows in genealogy-id order: (float fields (n, 9), integer
    fields (n, 3))."""
    m = multiset_with_ids(state)
    order = np.lexsort((m[:, 11].view(np.uint32), m[:, 10].view(np.uint32)))
    m = m[order]
    return m[:, :9].view(np.float32), m[:, 9:]


@functools.lru_cache(maxsize=None)
def _jax_sync(model: str):
    """JAX ``sync`` from its own seed state: (the seed state as numpy
    arrays, per-step metrics, per-step states as numpy arrays)."""
    size, knobs, table = MODELS[model]
    cfg = J.SimConfig(**size, **knobs, scheduler="sync")
    jt = jnp.asarray(_table(table))
    state = J.setup_particles(cfg)
    seed_state = interop.state_to_numpy(interop.state_from_numpy(
        {f: np.asarray(getattr(state, f)) for f in interop.FIELDS}, "cpu"))
    metrics, states = [], []
    for s in range(STEPS):
        state, m = j_step(state, jnp.uint32(s), jt, cfg)
        metrics.append({k: int(m[k]) for k in KEYS})
        states.append({f: np.asarray(getattr(state, f))
                       for f in interop.FIELDS})
    return seed_state, metrics, states


def _port_steps(model: str, scheduler="dynamic"):
    size, knobs, table = MODELS[model]
    cfg = SimConfig(**size, **knobs, scheduler=scheduler)
    check_supported(cfg)
    seed_state, _, _ = _jax_sync(model)
    state = interop.state_from_numpy(seed_state, "cpu")
    tt = interop.table_from_numpy(_table(table), "cpu")
    out = []
    for s in range(STEPS):
        state, m = poisson_step(state, s, tt, cfg)
        out.append(({k: int(m[k]) for k in KEYS}, state))
    return out


def _assert_matches_sync(model, port):
    _, metrics, states = _jax_sync(model)
    exact = MODELS[model][1].get("collision_model") != "isotropic"
    assert sum(m["added"] for m in metrics) > 0  # the MCC fired
    for s, ((pm, pst), jm, jst) in enumerate(zip(port, metrics, states)):
        assert pm == jm, f"step {s}: {pm} vs {jm}"
        jf, ji = _by_ids(interop.state_from_numpy(jst, "cpu"))
        pf, pi = _by_ids(pst)
        np.testing.assert_array_equal(pi, ji, err_msg=f"step {s} ids")
        if exact:
            np.testing.assert_array_equal(pf, jf, err_msg=f"step {s}")
        else:
            np.testing.assert_allclose(pf, jf, rtol=RTOL, atol=0,
                                       err_msg=f"step {s}")


@pytest.mark.parametrize("model", list(MODELS))
def test_dynamic_matches_jax_sync(model):
    _assert_matches_sync(model, _port_steps(model))


@pytest.mark.parametrize("scheduler", ["naive", "sync", "dynamic_old"])
def test_plain_cadences_match_jax_sync(scheduler):
    """Every plain cadence of the port carries the models (the
    magnetized-argon combination)."""
    _assert_matches_sync("magnetized_argon",
                         _port_steps("magnetized_argon", scheduler))


def test_magnetized_argon_grows():
    """The slice's churn: the argon table ionises the hot electrons, so the
    population grows every step; the periodic box loses none to the
    faces."""
    _, metrics, states = _jax_sync("magnetized_argon")
    ns = [MODELS["magnetized_argon"][0]["init_n"]] + [m["n"] for m in metrics]
    assert all(b > a for a, b in zip(ns, ns[1:])), ns
    pos = states[-1]["pos"][: ns[-1]]
    assert (pos >= 0).all() and (pos < 0.32).all()


def test_periodic_wraps_what_absorb_removes():
    """With no collisions, an absorbing box loses the lanes that cross a
    face in the step; a periodic one keeps them all, wrapped, in both
    packages alike."""
    knobs = dict(SMALL, mobility_dt=1e-9, init_vth=1e6, scheduler="dynamic",
                 cross_section_path="")
    zero = np.zeros((10000, 2), np.float32)
    removed = {}
    for boundary in ("absorb", "periodic"):
        cfg = SimConfig(**knobs, boundary=boundary)
        jcfg = J.SimConfig(**dict(knobs, scheduler="sync"),
                           boundary=boundary)
        js, jm = j_step(J.setup_particles(jcfg), jnp.uint32(0),
                        jnp.asarray(zero), jcfg)
        st, m = poisson_step(setup_particles(cfg, device="cpu"), 0,
                             torch.from_numpy(zero), cfg)
        assert {k: int(jm[k]) for k in KEYS} == {k: int(m[k]) for k in KEYS}
        removed[boundary] = m["removed"]
        pos = st.pos[: st.n].numpy()
        assert (pos >= 0).all() and (pos < 0.16).all()
    assert removed["absorb"] > 0 and removed["periodic"] == 0


# ---- the JAX package's own model checks, on the port ---------------------

def _one_lane_state(vx, n=8):
    z = torch.zeros(n)
    return tphys.Particles(
        px=z, py=z, pz=z, vx=torch.full((n,), vx), vy=z, vz=z, ax=z, ay=z,
        az=z, status=torch.full((n,), -1, dtype=torch.int32),
        id_hi=torch.zeros(n, dtype=torch.int32),
        id_lo=torch.zeros(n, dtype=torch.int32))


def test_boris_field_pure_gyration_conserves_energy():
    omega, dt = 3.0, 1e-2
    out = tphys.boris(_one_lane_state(2.0), dt, (0.0, 0.0, omega))
    speed = torch.stack([out.vx, out.vy, out.vz], 1).double().norm(dim=1)
    np.testing.assert_allclose(speed.numpy(), 2.0, rtol=1e-6)
    assert (out.vy < 0).all()  # v x t sends +x toward -y for +z Omega
    assert (out.vz == 0).all()
    angle = np.arctan2(-out.vy.double().numpy(), out.vx.double().numpy())
    np.testing.assert_allclose(angle, omega * dt, rtol=1e-3)


def test_boris_field_circular_orbit_closes():
    omega, dt, speed = 2.0, 2e-3, 1.0
    steps = int(round(2 * math.pi / (omega * dt)))
    q = _one_lane_state(speed, n=1)
    far = 0.0
    for _ in range(steps):
        q = tphys.boris(q, dt, (0.0, 0.0, omega))
        far = max(far, float(q.px[0]) ** 2 + float(q.py[0]) ** 2)
    assert math.hypot(float(q.px[0]), float(q.py[0])) < 0.02
    np.testing.assert_allclose(math.sqrt(far), 2 * speed / omega, rtol=0.01)


def test_boris_differs_from_leapfrog():
    pos, vel, acc, status, ids = _lanes(2, n=64)
    p = tphys.Particles(*(torch.from_numpy(np.ascontiguousarray(x)) for x in
                          (*pos, *vel, *acc, status)), None, None)
    dt = 1e-3
    lf, bo = tphys.leapfrog(p, dt), tphys.boris(p, dt)
    np.testing.assert_allclose(bo.vx.numpy(), lf.vx.numpy(), rtol=1e-6)
    delta = lf.px.double() - bo.px.double()
    expected = p.ax.double() * dt * dt / 2
    # a*dt^2/2 resolved where it is above the position's rounding
    big = expected.abs() > 1e-3 * p.px.double().abs().clamp(min=1e-30)
    assert big.any()
    np.testing.assert_allclose(delta[big].numpy(), expected[big].numpy(),
                               rtol=0.05)


def _port_run(knobs, steps=2):
    cfg = SimConfig(init_n=150, capacity=4096, poisson_timestep=5,
                    grid_size=(16, 16, 16), scheduler="sync", **knobs)
    table = cross_section.load_table(cross_section.bundled_paths()[1], "cpu")
    state = setup_particles(cfg, device="cpu")
    for s in range(steps):
        state, m = poisson_step(state, s, table, cfg)
    return state, m


def test_periodic_keeps_population_in_domain():
    state, m = _port_run(dict(boundary="periodic"))
    pos = state.pos[: m["n"]].numpy()
    assert m["n"] > 0 and (pos >= 0).all() and (pos < 0.16).all()


def test_isotropic_differs_from_reverse():
    a, _ = _port_run({})
    b, _ = _port_run(dict(collision_model="isotropic"))
    ma, mb = multiset_with_ids(a), multiset_with_ids(b)
    assert ma.shape != mb.shape or not np.array_equal(ma, mb)


def test_boris_field_changes_trajectories():
    a, _ = _port_run(dict(integrator="boris"))
    b, _ = _port_run(dict(integrator="boris", b_field=(0.0, 0.0, 1e9)))
    ma, mb = multiset_with_ids(a), multiset_with_ids(b)
    assert ma.shape != mb.shape or not np.array_equal(ma, mb)


@pytest.mark.slow
def test_dynamic_matches_jax_pallas_dynamic():
    """The magnetized-argon combination against the JAX work-log engine in
    Pallas interpret mode (minutes of compilation on one CPU): counters
    exact, floats within RTOL (the JAX engines agree with each other only
    to that bound under boris and isotropic)."""
    size, knobs, table = MODELS["magnetized_argon"]
    size = dict(size, init_n=500, poisson_timestep=10)
    cfg = J.SimConfig(**size, **knobs, scheduler="dynamic",
                      kernel_sublanes=8)
    jt = jnp.asarray(_table(table))
    jstate = J.setup_particles(cfg)
    state = interop.state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in interop.FIELDS}, "cpu")
    pcfg = SimConfig(**size, **knobs, scheduler="dynamic")
    tt = interop.table_from_numpy(_table(table), "cpu")
    for s in range(2):
        jstate, jm = j_step(jstate, jnp.uint32(s), jt, cfg)
        state, m = poisson_step(state, s, tt, pcfg)
        assert {k: int(m[k]) for k in KEYS} == {k: int(jm[k]) for k in KEYS}
        jf, ji = _by_ids(interop.state_from_numpy(
            {f: np.asarray(getattr(jstate, f)) for f in interop.FIELDS},
            "cpu"))
        pf, pi = _by_ids(state)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pf, jf, rtol=RTOL, atol=0)
