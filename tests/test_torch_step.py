"""Port parity for the slice as a whole: Poisson steps (field phase,
mobility phase, compaction) of the port against the JAX package's.

The port's ``dynamic`` on CPU tensors is the work-log engine's plain
version; it is held against JAX ``naive``, which the JAX package's own tests
hold equal to its work-log engine and its sync oracle.  The port's ``sync``
is held against JAX ``sync``; ``dynamic_old``: tests/test_torch_staged.py.  Required per step:
the same n, added, removed, overflow, pushes_lo and pushes_hi, and the same
sorted particle multiset with ids (tolerance: exact).

The second configuration runs at capacity 65,536 rather than 16,384: with
the constant 50/50 table a T=20 step appends ten times the live population,
which the naive cadence keeps until the step's compaction, so JAX naive
overflows at 16,384 (and drops children) where the work-log engine does not.
test_dynamic_reclaims_where_naive_overflows covers 16,384.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import particle_simulation_tpu as J
from particle_simulation_tpu.cross_section import bundled_paths
from particle_simulation_tpu.cross_section import load_table as j_load
from particle_simulation_tpu.ops.step import poisson_step as j_step
from particle_simulation_tpu.runtime import sorted_particle_array as j_sorted
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch.config import check_supported
from particle_simulation_tpu_torch.cross_section import load_table
from particle_simulation_tpu_torch.ops.step import poisson_loop, poisson_step
from particle_simulation_tpu_torch.runtime import (
    multiset_with_ids, run_pic, sorted_particle_array,
)
from particle_simulation_tpu_torch.schedulers import (
    get_mobility_phase, mobility_phase_naive,
)
from particle_simulation_tpu_torch.state import setup_particles

SIZES = {
    "small": dict(init_n=200, capacity=4096, grid_size=(16, 16, 16),
                  poisson_timestep=6),
    "mid": dict(init_n=2000, capacity=65536, grid_size=(32, 32, 32),
                poisson_timestep=20),
}
TABLES = {"sine": 0, "const": 1}
STEPS = 3
KEYS = ("n", "added", "removed", "overflow", "pushes_lo", "pushes_hi")


@functools.lru_cache(maxsize=None)
def _jax_run(size: str, table: str, capacity=None, scheduler="naive"):
    """JAX ``scheduler``: per-step (metrics, sorted array, multiset with
    ids)."""
    kw = dict(SIZES[size], scheduler=scheduler)
    if capacity:
        kw["capacity"] = capacity
    cfg = J.SimConfig(**kw)
    jt = j_load(bundled_paths()[TABLES[table]])
    state = J.setup_particles(cfg)
    out = []
    for s in range(STEPS):
        state, m = j_step(state, jnp.uint32(s), jt, cfg)
        metrics = {k: int(m[k]) for k in KEYS}
        numpy_state = {f: np.asarray(getattr(state, f))
                       for f in ("pos", "vel", "acc", "status", "id_hi",
                                 "id_lo", "n")}
        out.append((metrics, j_sorted(state),
                    multiset_with_ids(interop.state_from_numpy(numpy_state,
                                                               "cpu"))))
    return out


def _port_run(cfg, table: str):
    t = load_table(bundled_paths()[TABLES[table]], "cpu")
    state = setup_particles(cfg, device="cpu")
    out = []
    for s in range(STEPS):
        state, m = poisson_step(state, s, t, cfg)
        out.append(({k: int(m[k]) for k in KEYS}, sorted_particle_array(state),
                    multiset_with_ids(state)))
    return out


def _assert_same(port, ref):
    for s, ((pm, ps, pi), (jm, js, ji)) in enumerate(zip(port, ref)):
        assert pm == jm, f"step {s}"
        np.testing.assert_array_equal(ps, js, err_msg=f"step {s}")
        np.testing.assert_array_equal(pi, ji, err_msg=f"step {s} ids")


@pytest.mark.parametrize("depth", [2, 1])
@pytest.mark.parametrize("table", ["const", "sine"])
@pytest.mark.parametrize("size", ["small", "mid"])
def test_dynamic_matches_jax_naive(size, table, depth):
    cfg = SimConfig(**SIZES[size], scheduler="dynamic", spawn_depth=depth)
    ref = _jax_run(size, table)
    if table == "const":
        assert sum(m["added"] for m, _, _ in ref) > 0  # the MCC fired
    _assert_same(_port_run(cfg, table), ref)


@pytest.mark.parametrize("table", ["const", "sine"])
def test_naive_matches_jax_naive(table):
    cfg = SimConfig(**SIZES["small"], scheduler="naive")
    _assert_same(_port_run(cfg, table), _jax_run("small", table))


def test_naive_overflow_matches_jax_naive():
    """Both drop the children past capacity and count them."""
    cfg = SimConfig(**dict(SIZES["mid"], capacity=16384), scheduler="naive")
    ref = _jax_run("mid", "const", capacity=16384)
    assert ref[0][0]["overflow"]
    _assert_same(_port_run(cfg, "const"), ref)


def test_dynamic_reclaims_where_naive_overflows():
    """At capacity 16,384 the plain work-log version reclaims dead rows
    mid-phase (as the kernel's done log holds only live particles) and
    equals the unclamped naive run at 65,536."""
    cfg = SimConfig(**dict(SIZES["mid"], capacity=16384), scheduler="dynamic")
    port = _port_run(cfg, "const")
    assert not any(m["overflow"] for m, _, _ in port)
    _assert_same(port, _jax_run("mid", "const"))


def test_dynamic_output_is_compacted():
    cfg = SimConfig(**SIZES["small"], scheduler="dynamic")
    t = load_table(bundled_paths()[1], "cpu")
    state, m = poisson_step(setup_particles(cfg, device="cpu"), 0, t, cfg)
    status = state.status.numpy()
    assert state.n == m["n"] > 0
    assert (status[: state.n] == -1).all() and (status[state.n:] == 0).all()


def test_poisson_loop_and_run_pic_match_steps():
    cfg = SimConfig(**SIZES["small"], scheduler="dynamic", poisson_steps=STEPS)
    t = load_table(bundled_paths()[1], "cpu")
    ref = _port_run(cfg, "const")
    state, metrics = poisson_loop(setup_particles(cfg, device="cpu"), t, cfg,
                                  STEPS)
    for s, (m, _, ids) in enumerate(ref):
        assert {k: metrics[k][s] for k in KEYS} == m
    np.testing.assert_array_equal(multiset_with_ids(state), ref[-1][2])
    run = run_pic(cfg, t, device="cpu")
    assert run.final_n == ref[-1][0]["n"]
    assert [s.added for s in run.steps] == [m["added"] for m, _, _ in ref]


def test_poisson_loop_stops_at_zero_population():
    cfg = SimConfig(**dict(SIZES["small"], init_n=0), scheduler="dynamic")
    t = load_table(bundled_paths()[1], "cpu")
    state, metrics = poisson_loop(setup_particles(cfg, device="cpu"), t, cfg,
                                  2)
    assert state.n == 0 and metrics["n"] == [0, 0]
    assert metrics["overflow"] == [False, False]


@pytest.mark.parametrize("size", ["small", "mid"])
def test_sync_matches_jax_sync(size):
    cfg = SimConfig(**SIZES[size], scheduler="sync")
    ref = _jax_run(size, "const", scheduler="sync")
    assert sum(m["added"] for m, _, _ in ref) > 0
    _assert_same(_port_run(cfg, "const"), ref)


@pytest.mark.parametrize("name", ["other"])
def test_unported_schedulers_raise(name):
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_mobility_phase(name)


@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
def test_stamp_domain_raises_for_fused_engines(scheduler):
    cfg = SimConfig(**dict(SIZES["small"], poisson_timestep=32766),
                    scheduler=scheduler)
    with pytest.raises(ValueError, match="stamp domain"):
        check_supported(cfg)


def test_poisson_step_folds_reclaimed_rows():
    """A phase that reclaims dead rows mid-phase and does not compact
    itself (here the naive cadence with reclamation, at a capacity where
    it must reclaim) gives the metrics of the same phase without
    reclamation at a capacity that holds every row."""
    reclaimed = []

    def reclaiming_naive(*args):
        state, info = mobility_phase_naive(*args, reclaim=True)
        reclaimed.append(info["reclaimed"])
        return state, info

    cfg = SimConfig(**dict(SIZES["mid"], capacity=16384), scheduler="naive")
    t = load_table(bundled_paths()[1], "cpu")
    state = setup_particles(cfg, device="cpu")
    port = []
    for s in range(2):
        state, m = poisson_step(state, s, t, cfg, phase=reclaiming_naive)
        port.append(({k: int(m[k]) for k in KEYS}, sorted_particle_array(state),
                     multiset_with_ids(state)))
    assert sum(reclaimed) > 0
    _assert_same(port, _jax_run("mid", "const")[:2])
