"""The staged CUDA kernel (csrc/staged.cu) against its plain PyTorch version,
on the card.

These tests need a CUDA GPU and nvcc and skip elsewhere.  This file imports
no JAX, so a GPU machine without JAX runs it (skipping conftest.py):

    python -m pytest tests/test_torch_staged_kernels.py -m cuda --noconftest

Tolerance: exact (every output tensor bit for bit on the const table, the
sorted multiset with ids, and every counter: n, added, removed, overflow,
pushes, the passes and the reclaimed rows).
"""

import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import bundled_paths, load_table
from particle_simulation_tpu_torch.ops.kernels import build, engine
from particle_simulation_tpu_torch.ops.kernels import push_mcc as pm
from particle_simulation_tpu_torch.ops.step import grid_phase, poisson_step
from particle_simulation_tpu_torch.runtime import multiset_with_ids
from particle_simulation_tpu_torch.state import setup_particles

import kept_outputs

pytestmark = pytest.mark.cuda

CHURN = dict(init_n=3000, capacity=65536, grid_size=(32, 32, 32),
             poisson_timestep=20, scheduler="dynamic_old")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card with -m cuda)")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda", 0)


def _same_bits(a, b):
    return a.n == b.n and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a[:6], b[:6]))


def _phase(cfg, table, st, s=0, opened=False):
    """Kernel and plain phase from the same state; the kernel's output.
    ``opened``: the kernel through the open instantiation at any pair."""
    if opened:
        before = pm.staged_phase.open_launches
        bufs = pm.staged_phase.buffers(st, cfg, engine.open_blocks(
            "staged", cfg, st.device))
        k, ki = pm.staged_phase.run(st, bufs, s, table, cfg,
                                    cfg.poisson_timestep)
        assert pm.staged_phase.open_launches - before == 1
    else:
        k, ki = pm.mobility_phase_dynamic(st, s, table, cfg,
                                          cfg.poisson_timestep)
    p, pi = pm.mobility_phase_dynamic_plain(st, s, table, cfg,
                                            cfg.poisson_timestep)
    assert ki == pi, (s, ki, pi)
    assert _same_bits(k, p), s
    return k, ki


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("mode,rounds", [("block2", 13), ("perstep", 20)])
def test_phase_matches_plain(dev, depth, mode, rounds):
    """Two whole phases, each from the same state: every output tensor,
    the counters, the passes and the reclaimed rows."""
    cfg = SimConfig(**CHURN, spawn_depth=depth, rng_mode=mode,
                    rng_rounds=rounds)
    table = load_table(bundled_paths()[1], dev)
    st = setup_particles(cfg, device=dev)
    for s in range(2):
        st, info = _phase(cfg, table, grid_phase(st, cfg), s)
        assert info["passes"] > 1 and info["added"] > 0


def _steps(cfg, table, dev, steps):
    """Kernel, plain version and the work-log kernel from the same state
    each Poisson step; returns the kernel's per-step info."""
    dyn = cfg.replace(scheduler="dynamic")
    infos = []

    def kernel(*args):
        state, info = pm.mobility_phase_dynamic(*args)
        infos.append(info)
        return state, info

    kernel.self_compacting = pm.mobility_phase_dynamic.self_compacting
    st = setup_particles(cfg, device=dev)
    for s in range(steps):
        k, km = poisson_step(st, s, table, cfg, phase=kernel)
        p, pm_ = poisson_step(st, s, table, cfg,
                              phase=pm.mobility_phase_dynamic_plain)
        d, dm = poisson_step(st, s, table, dyn)
        assert km == pm_ == dm, (s, km, pm_, dm)
        assert (multiset_with_ids(k) == multiset_with_ids(p)).all()
        assert (multiset_with_ids(k) == multiset_with_ids(d)).all()
        st = k
    return infos


def test_phase_matches_plain_and_dynamic_const(dev):
    table = load_table(bundled_paths()[1], dev)
    _steps(SimConfig(**CHURN), table, dev, steps=3)


def test_phase_matches_plain_and_dynamic_sine(dev):
    cfg = SimConfig(init_n=200_000, capacity=400_000, grid_size=(128,) * 3,
                    poisson_timestep=100, scheduler="dynamic_old")
    _steps(cfg, load_table(bundled_paths()[0], dev), dev, steps=3)


def test_reclaims_where_the_children_do_not_fit(dev):
    """At capacity 16,384 the kernel reclaims on the card before appending
    and equals the plain version and the work-log kernel (whose done log
    holds live records only)."""
    cfg = SimConfig(**dict(CHURN, capacity=16384))
    reclaims = pm.staged_phase.reclaims
    infos = _steps(cfg, load_table(bundled_paths()[1], dev), dev, steps=3)
    assert sum(i["reclaimed"] for i in infos) > 0
    assert pm.staged_phase.reclaims > reclaims


def test_launch_counter_counts_passes(dev):
    cfg = SimConfig(**CHURN)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    launches, passes = pm.staged_phase.launches, pm.staged_phase.passes
    pm.mobility_phase_dynamic(st, 0, table, cfg, cfg.poisson_timestep)
    # one launch a phase; the const table's children chain through one
    # pass per step, counted on the card
    assert pm.staged_phase.launches - launches == 1
    assert pm.staged_phase.passes - passes > 1


def test_two_runs_give_identical_tensors(dev):
    """Ranks depend on counts alone: every output tensor is the same, bit
    for bit, run after run."""
    cfg = SimConfig(**CHURN)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    a, ai = pm.mobility_phase_dynamic(st, 0, table, cfg, cfg.poisson_timestep)
    b, bi = pm.mobility_phase_dynamic(st, 0, table, cfg, cfg.poisson_timestep)
    assert ai == bi and ai["added"] > 0
    assert _same_bits(a, b)


def test_input_state_is_not_written(dev):
    cfg = SimConfig(**CHURN)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    before = [t.clone() for t in st[:6]]
    pm.mobility_phase_dynamic(st, 0, table, cfg, cfg.poisson_timestep)
    torch.cuda.synchronize()
    for x, y in zip(st[:6], before):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("depth,rounds,opened", [
    (2, 13, False), (2, 13, True), (6, 12, True),
], ids=["compiled", "open", "open_6_12"])
def test_appends_past_the_capacity_overflow(dev, depth, rounds, opened):
    """3,000 electrons at a capacity of 3,000: the children of the first
    pass pass the capacity even after the reclaim, so some are dropped
    (counted in n) and overflow is flagged; the output is compacted to at
    most C rows, equal to the plain version's.  The open instantiation
    too, at the compiled pair and at a depth outside the compiled set."""
    cfg = SimConfig(**dict(CHURN, capacity=3000), spawn_depth=depth,
                    rng_rounds=rounds)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    out, info = _phase(cfg, table, st, opened=opened)
    assert info["overflow"] and 0 < out.n <= cfg.capacity
    assert info["removed"] == cfg.init_n + info["added"] - out.n
    assert pm.staged_phase.last["n"] > cfg.capacity
    assert bool((out.status[:out.n] == -1).all())
    assert bool((out.status[out.n:] == 0).all())


MAGNETIZED_ARGON = dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                        collision_model="isotropic", boundary="periodic",
                        init_vth=2.0e6)


@pytest.mark.parametrize("model", ["reference", "general"])
@pytest.mark.parametrize("rounds", [5, 12, 24])
@pytest.mark.parametrize("depth", [5, 6, 8, 16])
def test_open_variants_match_plain(dev, depth, rounds, model):
    """Outside the compiled set (depth 1..4, rounds 13 and 20) the open
    instantiation runs, one launch a phase, equal to the plain version bit
    for bit; depth 16 passes the block's 12 warps, whose look-backs the
    open instantiation takes two streams at a time."""
    models = MAGNETIZED_ARGON if model == "general" else {}
    cfg = SimConfig(**CHURN, **models, spawn_depth=depth, rng_rounds=rounds)
    assert not engine.compiled(cfg) and (
        engine.model_bits(cfg) != 0) == bool(models)
    table = load_table(bundled_paths()[1], dev)
    st = setup_particles(cfg, device=dev)
    launches, opened = pm.staged_phase.launches, pm.staged_phase.open_launches
    added = 0
    for s in range(2):
        st, info = _phase(cfg, table, grid_phase(st, cfg), s)
        added += info["added"]
    assert added > 0
    assert pm.staged_phase.launches - launches == 2
    assert pm.staged_phase.open_launches - opened == 2


def test_table_on_the_wrong_device_raises(dev):
    cfg = SimConfig(**CHURN)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    with pytest.raises(ValueError, match="table"):
        pm.mobility_phase_dynamic(st, 0, load_table(device="cpu"), cfg,
                                  cfg.poisson_timestep)


@pytest.mark.parametrize("population", kept_outputs.POPULATIONS)
@pytest.mark.parametrize("instantiation", list(kept_outputs.INSTANTIATIONS))
def test_kept_output_equals_fresh(dev, instantiation, population):
    """A kept output with poison rows below its mark: every capacity row
    of the phase's output equals the fresh path's, bit for bit (the
    overflow at a capacity of 3,000, as above)."""
    knobs = dict(capacity=3000) if population == "overflow" else {}
    cfg = kept_outputs.config(CHURN, instantiation, **knobs)
    kept_outputs.check_poisoned_output(pm.staged_phase,
                                       pm.mobility_phase_dynamic, cfg,
                                       population, dev)


@pytest.mark.parametrize("instantiation", list(kept_outputs.INSTANTIATIONS))
def test_held_states_are_left_alone(dev, instantiation):
    kept_outputs.check_held_states(
        pm.staged_phase, kept_outputs.config(CHURN, instantiation), dev)


@pytest.mark.parametrize("instantiation", list(kept_outputs.INSTANTIATIONS))
def test_output_written_in_place_is_cleared(dev, instantiation):
    kept_outputs.check_in_place_step(
        pm.staged_phase, pm.mobility_phase_dynamic,
        kept_outputs.config(CHURN, instantiation), dev)
