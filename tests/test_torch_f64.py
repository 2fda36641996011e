"""The port's float64 oracle mode (``precision="f64"``) against the JAX
package's own float64 runs under ``jax_enable_x64``.

* the emulated float64 fused multiply-add (``fma.fma_f64``) is correctly
  rounded: exact rationals on random and cancelling inputs;
* XLA:CPU contracts the float64 multiply-adds at the float32 sites: each
  site is written fused (the port) and plain, over 10^5 random lanes of
  the compiled step, and only the fused form equals XLA's (this is the
  measurement ``fma.py``'s docstring reports);
* one mobility step of every model, the bucket index and the elementary
  functions: bitwise;
* whole runs of ``naive`` and ``sync`` on the const and the sine tables,
  with the reference model and the magnetized combination (boris with a
  field, isotropic children, the periodic box, a thermal start), at
  tests/test_oracle.py's sizes: n, added, removed, the id multiset and
  every float bitwise.  The thermal start's float32 normal draws go
  through XLA:CPU's float32 ``log`` and ``cos`` (tests/test_torch_models.py
  bounds them), so the runs with ``init_vth`` start from JAX's initial
  state, and the start itself is held to that bound.

The x64 flag is switched on only inside ``x64()`` and restored in
``finally``, so no other test of the worker sees it.
"""

import contextlib
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particle_simulation_tpu as J
from particle_simulation_tpu import cross_section as jcs
from particle_simulation_tpu import state as jstate
from particle_simulation_tpu.ops import physics as jphys
from particle_simulation_tpu.ops.step import make_table_lookup
from particle_simulation_tpu.runtime import run_pic as jax_run_pic
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch import cross_section as tcs
from particle_simulation_tpu_torch.fma import elementary, fma_f64
from particle_simulation_tpu_torch.ops import physics as tphys
from particle_simulation_tpu_torch.ops.kernels import push_mcc, worklog
from particle_simulation_tpu_torch.runtime import run_pic
from particle_simulation_tpu_torch.state import setup_particles

CONST = jcs.bundled_paths()[1]
N = 100_000
DT = 1e-12
SIZE = (0.16, 0.16, 0.16)
# the thermal start's bound against XLA:CPU's float32 log and cos, as
# tests/test_torch_models.py measured and states it
GAUSS_MAX_ULPS = 3
GAUSS_MAX_SHARE = 0.1


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def jax_config(cfg: SimConfig) -> J.SimConfig:
    return J.SimConfig(**dataclasses.asdict(cfg))


# ---- the float64 fused multiply-add ---------------------------------------

def test_fma_f64_correctly_rounded():
    r = np.random.default_rng(0)
    n = 20_000
    a = r.standard_normal(n) * 10.0 ** r.uniform(-8, 8, n)
    b = r.standard_normal(n) * 10.0 ** r.uniform(-8, 8, n)
    # half the adds cancel the product to 0-17 digits
    c = -(a * b) * (1 + r.standard_normal(n) * 10.0 ** r.uniform(-17, 0, n))
    c[: n // 2] = r.standard_normal(n // 2) * 10.0 ** r.uniform(-12, 12, n // 2)
    got = fma_f64(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    assert (a * b + c != want).sum() > n // 4  # the plain form is not it
    inf = torch.tensor([np.inf, -np.inf, 1.0], dtype=torch.float64)
    out = fma_f64(inf, 2.0, torch.tensor([1.0, 1.0, -np.inf],
                                         dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(out, [np.inf, -np.inf, -np.inf])


# ---- one mobility step ----------------------------------------------------

def _lanes(seed):
    r = np.random.default_rng(seed)
    pos = r.uniform(-1e-5, 0.16 + 1e-5, (3, N))
    pos[:, : N // 2] = r.uniform(0.0, 1e-5, (3, N // 2))
    vel = r.standard_normal((3, N)) * 10.0 ** r.uniform(3, 8, N)
    acc = (r.standard_normal((3, N)) * 10.0 ** r.uniform(14, 19, N)).astype(
        np.float32)
    status = r.choice(np.array([-1, -2, 0, 1, 5], np.int32), N)
    ids = r.integers(0, 1 << 32, (2, N), dtype=np.uint64).astype(np.uint32)
    return pos, vel, acc, status, ids


MODELS = {
    "reference": {},
    "boris": dict(integrator="boris"),
    "boris_b": dict(integrator="boris", b_field=(3e11, -5e11, 7e11)),
    "isotropic": dict(collision_model="isotropic"),
    "periodic": dict(boundary="periodic"),
    "magnetized": dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                       collision_model="isotropic", boundary="periodic"),
}


def _jax_step(fields, active, t, table, model):
    p = jphys.Particles(*fields)
    model = dict(model)
    b = model.pop("b_field", None)
    kick = jphys.make_kick(model.get("integrator", "leapfrog"),
                           (p.ax, p.ay, p.az), DT, jnp.float64, b_field=b)
    return jphys.update_particles(
        p, active=active, t=t, poisson_step=jnp.uint32(3), dt=DT,
        sim_size=SIZE, split_chance=None, remove_chance=None, seed=39587,
        table_lookup=make_table_lookup(table), rng_rounds=13,
        rng_mode="block2", kick=kick, **model)


def _step_pair(model, t=4):
    pos, vel, acc, status, ids = _lanes(t + len(model))
    table = jcs.load_table(CONST)
    active = (status == -1) | ((status > 0) & (t > status))
    jfields = [*pos, *vel, *acc, status, ids[0], ids[1]]
    with x64():
        jres = jax.jit(_jax_step, static_argnums=(2, 4))(
            [jnp.asarray(x) for x in jfields], jnp.asarray(active), t, table,
            tuple(sorted(model.items())))
        jres = jax.tree_util.tree_map(np.asarray, jres)
    tf = [torch.from_numpy(np.ascontiguousarray(x))
          for x in (*pos, *vel, *acc, status)]
    tf += [torch.from_numpy(ids[k].view(np.int32).copy()) for k in (0, 1)]
    tres = tphys.update_particles(
        tphys.Particles(*tf), active=torch.from_numpy(active), t=t,
        poisson_step=3, dt=DT, sim_size=SIZE, seed=39587,
        table=torch.from_numpy(np.array(table)), rng_rounds=13,
        rng_mode="block2", **model)
    return jres, tres, tf


@pytest.mark.parametrize("model", list(MODELS))
def test_update_particles_f64_bitwise(model):
    jres, tres, _ = _step_pair(MODELS[model])
    spawn = tres.spawn.numpy()
    np.testing.assert_array_equal(jres.spawn, spawn)
    assert spawn.any() and (tres.particles.status == -2).any()
    for group, jg, tg in (("parent", jres.particles, tres.particles),
                          ("child", jres.child, tres.child)):
        for name, a, b in zip(jphys.Particles._fields, jg, tg):
            b = b.numpy()
            if name in ("id_hi", "id_lo"):
                b = b.view(np.uint32)
            if name in ("px", "vx"):
                assert b.dtype == np.float64
            if group == "child":
                a, b = a[spawn], b[spawn]
            np.testing.assert_array_equal(a, b, err_msg=f"{group}.{name}")


def test_f64_contraction_sites():
    """The drift and the collision energy, written fused (as the port
    writes them) equal XLA:CPU's float64 results; written as a plain
    multiply and add they do not."""
    jres, tres, tf = _step_pair({})
    px, vx, ax = tf[0], tf[3], tf[6].to(torch.float64)
    h = DT / 2
    vm = vx - ax * h
    moved = np.asarray(jres.particles.px)
    act = tres.particles.px.numpy() != px.numpy()  # lanes that moved
    plain = (px + vm * DT).numpy()
    fused = fma_f64(fma_f64(-ax, h, vx), DT, px).numpy()
    np.testing.assert_array_equal(fused[act], moved[act])
    assert (plain[act] != moved[act]).sum() > 0
    v = [torch.from_numpy(np.array(getattr(jres.particles, f)))
         for f in ("vx", "vy", "vz")]
    with x64():
        want = np.asarray(jax.jit(jphys.collision_energy)(jphys.Particles(
            None, None, None, *(jnp.asarray(x.numpy()) for x in v),
            *([None] * 6))))
    got = tphys.collision_energy(tphys.Particles(None, None, None, *v,
                                                 *([None] * 6))).numpy()
    np.testing.assert_array_equal(got, want)
    plain = (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]).numpy()
    assert (plain != want).sum() > 0


def test_energy_to_index_f64():
    r = np.random.default_rng(5)
    e = np.concatenate([10.0 ** r.uniform(-8, 18, 300_000), [0.0, 1e-300]])
    with x64():
        want = np.asarray(jax.jit(jcs.energy_to_index)(jnp.asarray(e)))
    got = tcs.energy_to_index(torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sqrt", "cos", "sin"])
def test_elementary_f64_matches_xla(name):
    r = np.random.default_rng(6)
    x = (10.0 ** r.uniform(-8, 18, 100_000) if name == "sqrt"
         else r.uniform(0.0, 2 * np.pi, 100_000))
    with x64():
        want = np.asarray(jax.jit(getattr(jnp, name))(x))
    np.testing.assert_array_equal(
        elementary(name, torch.from_numpy(x)).numpy(), want)


# ---- whole runs -----------------------------------------------------------

ORACLE_CONST = SimConfig(init_n=200, capacity=20_000, poisson_steps=3,
                         poisson_timestep=6, grid_size=(32, 32, 32),
                         cross_section_path=CONST)
ORACLE_SINE = SimConfig(init_n=100, capacity=1000, poisson_steps=2,
                        poisson_timestep=8, grid_size=(32, 32, 32))
MAGNETIZED = dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                  collision_model="isotropic", boundary="periodic",
                  init_vth=2e6)
RUNS = {
    f"{table}-{model}": base.replace(precision="f64", **kw)
    for table, base in (("const", ORACLE_CONST), ("sine", ORACLE_SINE))
    for model, kw in (("reference", {}), ("magnetized", MAGNETIZED))
}


def live_sorted(arrays) -> dict:
    """The live rows of a state given as numpy arrays, ordered by ids."""
    st = np.asarray(arrays["status"])
    n = min(int(np.asarray(arrays["n"])), st.shape[0])
    live = np.zeros(st.shape, bool)
    live[:n] = (st[:n] == -1) | (st[:n] > 0)
    hi = np.asarray(arrays["id_hi"]).view(np.uint32)[live]
    lo = np.asarray(arrays["id_lo"]).view(np.uint32)[live]
    order = np.lexsort((lo, hi))
    return {f: np.asarray(arrays[f])[live][order]
            for f in ("pos", "vel", "acc", "status", "id_hi", "id_lo")}


@pytest.fixture(scope="module")
def jax_runs():
    """{(run, scheduler): (history, live rows, initial state)} of JAX's x64
    runs; the initial state is JAX's own setup (eager, as run_pic
    calls it)."""
    out = {}
    with x64():
        for name, cfg in RUNS.items():
            jcfg = jax_config(cfg)
            init = jstate.setup_particles(jcfg)
            init_np = {f: np.asarray(getattr(init, f))
                       for f in interop.FIELDS}
            for s in ("naive", "sync"):
                res = jax_run_pic(jcfg.replace(scheduler=s),
                                  print_header=False, initial_state=init)
                hist = [(m.n, m.added, m.removed) for m in res.steps]
                live = live_sorted({f: np.asarray(getattr(res.state, f))
                                    for f in interop.FIELDS})
                out[(name, s)] = (hist, live, init_np)
    return out


@pytest.mark.parametrize("scheduler", ["naive", "sync"])
@pytest.mark.parametrize("run", list(RUNS))
def test_f64_run_equals_jax_x64(jax_runs, run, scheduler):
    cfg = RUNS[run].replace(scheduler=scheduler)
    want_hist, want, init_np = jax_runs[(run, scheduler)]
    start = None
    if cfg.init_vth:
        start = interop.state_from_numpy(init_np, "cpu", torch.float64)
    res = run_pic(cfg, print_header=False, initial_state=start, device="cpu")
    assert res.state.pos.dtype == torch.float64
    assert [(m.n, m.added, m.removed) for m in res.steps] == want_hist
    assert want_hist[-1][0] > 0
    got = live_sorted(interop.state_to_numpy(res.state))
    for f in ("status", "id_hi", "id_lo", "pos", "vel", "acc"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    if run.startswith("const"):
        assert sum(m.added for m in res.steps) > 0


def test_f64_setup_equals_jax(jax_runs):
    """The seeded positions are exact; the thermal start's velocities are
    the float32 normal draws (widened exactly) times init_vth in float64,
    each draw within tests/test_torch_models.py's bound of XLA:CPU's."""
    for name, cfg in RUNS.items():
        init = jax_runs[(name, "naive")][2]
        got = interop.state_to_numpy(setup_particles(cfg, device="cpu"))
        assert got["pos"].dtype == got["vel"].dtype == np.float64
        np.testing.assert_array_equal(got["pos"], init["pos"])
        g = (got["vel"] / cfg.init_vth).astype(np.float32) if cfg.init_vth \
            else got["vel"].astype(np.float32)
        w = (init["vel"] / cfg.init_vth).astype(np.float32) if cfg.init_vth \
            else init["vel"].astype(np.float32)
        ulps = np.abs(g.view(np.int32).astype(np.int64)
                      - w.view(np.int32).astype(np.int64))
        assert ulps.max() <= GAUSS_MAX_ULPS
        assert (ulps > 0).mean() <= GAUSS_MAX_SHARE


# ---- the engines refuse float64 -------------------------------------------

F32_ONLY = "is f32-only; use scheduler='sync' or 'naive' for f64 oracle runs"


@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
def test_engines_refuse_f64(scheduler):
    cfg = ORACLE_CONST.replace(precision="f64", scheduler=scheduler)
    with pytest.raises(ValueError, match=F32_ONLY):
        run_pic(cfg, print_header=False, device="cpu")
    state = setup_particles(cfg.replace(scheduler="sync"), device="cpu")
    table = tcs.load_table(CONST, "cpu")
    phases = ((worklog.mobility_phase_worklog,
               worklog.mobility_phase_worklog_plain)
              if scheduler == "dynamic" else
              (push_mcc.mobility_phase_dynamic,
               push_mcc.mobility_phase_dynamic_plain))
    for phase in phases:
        with pytest.raises(ValueError, match=F32_ONLY):
            phase(state, 0, table, cfg, cfg.poisson_timestep)
