"""The work-log CUDA kernel against its plain PyTorch version, on the card,
and both engines (work-log and staged) under each model of the menu.

These tests need a CUDA GPU and nvcc and skip elsewhere.  This file imports
no JAX, so a GPU machine without JAX runs it (skipping conftest.py):

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

Tolerance: exact (sorted multiset with ids, and every counter).
"""

import pytest
import torch

from particle_simulation_tpu_torch import SimConfig, cross_section
from particle_simulation_tpu_torch.cross_section import bundled_paths, load_table
from particle_simulation_tpu_torch.ops.kernels import build, engine
from particle_simulation_tpu_torch.ops.kernels import push_mcc as pm
from particle_simulation_tpu_torch.ops.kernels.worklog import (
    mobility_phase_worklog, mobility_phase_worklog_plain, worklog_phase,
)
from particle_simulation_tpu_torch.ops.step import grid_phase
from particle_simulation_tpu_torch.runtime import multiset_with_ids
from particle_simulation_tpu_torch.state import setup_particles

import kept_outputs

pytestmark = pytest.mark.cuda

CHURN = dict(init_n=3000, capacity=65536, grid_size=(32, 32, 32),
             poisson_timestep=20, scheduler="dynamic")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card with -m cuda)")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda", 0)


def _compare(cfg, table, dev, steps=2):
    st = setup_particles(cfg, device=dev)
    for s in range(steps):
        st = grid_phase(st, cfg)
        k, ki = mobility_phase_worklog(st, s, table, cfg, cfg.poisson_timestep)
        p, pi = mobility_phase_worklog_plain(st, s, table, cfg,
                                             cfg.poisson_timestep)
        assert (multiset_with_ids(k) == multiset_with_ids(p)).all()
        assert k.n == p.n and ki == pi, (s, ki, pi)
        st = k
    return ki


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("mode,rounds", [("block2", 13), ("perstep", 20)])
def test_kernel_matches_plain_const_table(dev, depth, mode, rounds):
    cfg = SimConfig(**CHURN, spawn_depth=depth, rng_mode=mode,
                    rng_rounds=rounds)
    table = load_table(bundled_paths()[1], dev)
    info = _compare(cfg, table, dev)
    assert info["added"] > 0


def test_kernel_matches_plain_sine_table(dev):
    cfg = SimConfig(init_n=200_000, capacity=400_000, grid_size=(128,) * 3,
                    poisson_timestep=100, scheduler="dynamic")
    table = load_table(bundled_paths()[0], dev)
    _compare(cfg, table, dev, steps=3)


def test_launch_counter_counts_passes(dev):
    cfg = SimConfig(**CHURN)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    launches, passes = worklog_phase.launches, worklog_phase.passes
    mobility_phase_worklog(st, 0, table, cfg, cfg.poisson_timestep)
    # one launch a phase; the const table's children chain through one
    # pass per step, counted on the card
    assert worklog_phase.launches - launches == 1
    assert worklog_phase.passes - passes > 1


def test_two_runs_give_identical_tensors(dev):
    """The emission order depends on counts alone: not only the multiset
    but every output tensor is the same, bit for bit, run after run."""
    cfg = SimConfig(**CHURN)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    a, ai = mobility_phase_worklog(st, 0, table, cfg, cfg.poisson_timestep)
    b, bi = mobility_phase_worklog(st, 0, table, cfg, cfg.poisson_timestep)
    assert ai == bi and a.n == b.n and ai["added"] > 0
    for x, y in zip(a[:6], b[:6]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_input_state_is_not_written(dev):
    cfg = SimConfig(**CHURN)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    before = [t.clone() for t in st[:6]]
    mobility_phase_worklog(st, 0, table, cfg, cfg.poisson_timestep)
    torch.cuda.synchronize()
    for x, y in zip(st[:6], before):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


# the overflow tests' kernels: the compiled instantiation, the open one at
# the same pair and the open one at a spawn depth outside the compiled set
# (13 rounds: the draws, and so the const churn's 3,078 survivors, do not
# depend on the depth)
OVERFLOW_VARIANTS = {"compiled": (2, 13, False), "open": (2, 13, True),
                     "open_depth6": (6, 13, True)}


def _overflow_phase(cfg, table, st, opened):
    """The phase through the compiled or the open instantiation; the open
    one at (2, 13) equal to the compiled one, bit for bit, past the
    overflow too."""
    if not opened:
        return mobility_phase_worklog(st, 0, table, cfg, cfg.poisson_timestep)
    opened_before = worklog_phase.open_launches
    bufs = worklog_phase.buffers(st, cfg, engine.open_blocks(
        "worklog", cfg, st.device))
    out, info = worklog_phase.run(st, bufs, 0, table, cfg,
                                  cfg.poisson_timestep)
    assert worklog_phase.open_launches - opened_before == 1
    if engine.compiled(cfg):
        ref, ref_info = mobility_phase_worklog(st, 0, table, cfg,
                                               cfg.poisson_timestep)
        assert ref_info == info and ref.n == out.n
        for x, y in zip(ref[:6], out[:6]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    return out, info


@pytest.mark.parametrize("variant", list(OVERFLOW_VARIANTS))
def test_work_log_overflow_is_flagged(dev, variant):
    depth, rounds, opened = OVERFLOW_VARIANTS[variant]
    cfg = SimConfig(**CHURN, worklog_rows=1, spawn_depth=depth,
                    rng_rounds=rounds)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    out, info = _overflow_phase(cfg, table, st, opened)
    assert info["overflow"] and out.n <= cfg.capacity


@pytest.mark.parametrize("variant", list(OVERFLOW_VARIANTS))
def test_done_log_overflow_is_flagged(dev, variant):
    """3,000 electrons of the const churn end the phase 3,078 strong (the
    plain version at a larger capacity): the done log passes a capacity of
    3,000 while the work logs (512 rows of 128) hold every pass."""
    depth, rounds, opened = OVERFLOW_VARIANTS[variant]
    cfg = SimConfig(**dict(CHURN, capacity=3000), worklog_rows=512,
                    spawn_depth=depth, rng_rounds=rounds)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    out, info = _overflow_phase(cfg, table, st, opened)
    assert info["overflow"] and out.n == cfg.capacity
    assert info["removed"] == cfg.init_n + info["added"] - cfg.capacity
    assert bool((out.status == -1).all())


@pytest.mark.parametrize("model", ["reference", "general"])
@pytest.mark.parametrize("rounds", [5, 12, 24])
@pytest.mark.parametrize("depth", [5, 6, 8, 16])
def test_open_variants_match_plain(dev, depth, rounds, model):
    """Outside the compiled set (depth 1..4, rounds 13 and 20) the open
    instantiation runs, one launch a phase, equal to the plain version."""
    models = MAGNETIZED_ARGON if model == "general" else {}
    cfg = SimConfig(**CHURN, **models, spawn_depth=depth, rng_rounds=rounds)
    assert not engine.compiled(cfg) and (
        engine.model_bits(cfg) != 0) == bool(models)
    table = load_table(bundled_paths()[1], dev)
    launches, opened = worklog_phase.launches, worklog_phase.open_launches
    assert _compare(cfg, table, dev)["added"] > 0
    assert worklog_phase.launches - launches == 2
    assert worklog_phase.open_launches - opened == 2


def test_table_on_the_wrong_device_raises(dev):
    cfg = SimConfig(**CHURN)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    with pytest.raises(ValueError, match="table"):
        mobility_phase_worklog(st, 0, load_table(device="cpu"), cfg,
                               cfg.poisson_timestep)


MAGNETIZED_ARGON = dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                        collision_model="isotropic", boundary="periodic",
                        init_vth=2.0e6)
MODELS = {
    "boris": dict(integrator="boris"),
    "boris_field": dict(integrator="boris", b_field=(3e11, -5e11, 7e11)),
    # 0.1 cell a step: lanes cross the faces
    "periodic": dict(boundary="periodic", mobility_dt=1e-9, init_vth=1e6),
    "isotropic": dict(collision_model="isotropic"),
    "thermal": dict(init_vth=2e6),
    "all": MAGNETIZED_ARGON,
}


@pytest.mark.parametrize("depth", [2, 1])
@pytest.mark.parametrize("model", list(MODELS))
def test_models_match_plain_both_engines(dev, model, depth):
    """Each model through the general instantiations: each engine equal to
    its plain version, and the two engines equal (exact)."""
    cfg = SimConfig(**CHURN, **MODELS[model], spawn_depth=depth)
    table = load_table(bundled_paths()[1], dev)
    # the thermal start changes the seed state, not the kernel's path
    assert engine.model_bits(cfg) != 0 or model == "thermal"
    st = setup_particles(cfg, device=dev)
    for s in range(2):
        st = grid_phase(st, cfg)
        k, ki = mobility_phase_worklog(st, s, table, cfg, cfg.poisson_timestep)
        p, pi = mobility_phase_worklog_plain(st, s, table, cfg,
                                             cfg.poisson_timestep)
        o, oi = pm.mobility_phase_dynamic(st, s, table, cfg,
                                          cfg.poisson_timestep)
        assert ki == pi and ki["added"] > 0, (s, ki, pi)
        assert {key: oi[key] for key in ki} == ki, (s, oi, ki)
        want = multiset_with_ids(p)
        assert (multiset_with_ids(k) == want).all()
        assert (multiset_with_ids(o) == want).all()
        st = k


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("mode,rounds", [("block2", 13), ("perstep", 20)])
def test_all_models_every_instantiation(dev, depth, mode, rounds):
    """The models together through every general instantiation of the
    work-log engine (depth x rounds x draw protocol), against its plain
    version (exact)."""
    cfg = SimConfig(**CHURN, **MAGNETIZED_ARGON, spawn_depth=depth,
                    rng_mode=mode, rng_rounds=rounds)
    table = load_table(bundled_paths()[1], dev)
    assert _compare(cfg, table, dev)["added"] > 0


def test_magnetized_argon_matches_plain(dev):
    cfg = SimConfig(init_n=20000, capacity=65536, grid_size=(64, 64, 64),
                    poisson_timestep=100, scheduler="dynamic",
                    **MAGNETIZED_ARGON)
    table = torch.from_numpy(cross_section.argon_like_table(1e23, 1e-12))
    info = _compare(cfg, table.to(dev), dev, steps=2)
    assert info["added"] > 0


@pytest.mark.parametrize("population", kept_outputs.POPULATIONS)
@pytest.mark.parametrize("instantiation", list(kept_outputs.INSTANTIATIONS))
def test_kept_output_equals_fresh(dev, instantiation, population):
    """A kept output with poison rows below its mark: every capacity row
    of the phase's output equals the fresh path's, bit for bit (the
    overflow at a done log of 3,000 rows, as above)."""
    knobs = (dict(capacity=3000, worklog_rows=512)
             if population == "overflow" else {})
    cfg = kept_outputs.config(CHURN, instantiation, **knobs)
    kept_outputs.check_poisoned_output(worklog_phase, mobility_phase_worklog,
                                       cfg, population, dev)


@pytest.mark.parametrize("instantiation", list(kept_outputs.INSTANTIATIONS))
def test_held_states_are_left_alone(dev, instantiation):
    kept_outputs.check_held_states(
        worklog_phase, kept_outputs.config(CHURN, instantiation), dev)


@pytest.mark.parametrize("instantiation", list(kept_outputs.INSTANTIATIONS))
def test_output_written_in_place_is_cleared(dev, instantiation):
    kept_outputs.check_in_place_step(
        worklog_phase, mobility_phase_worklog,
        kept_outputs.config(CHURN, instantiation), dev)
