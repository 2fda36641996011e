"""The work-log CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA GPU and nvcc and skip elsewhere.  This file imports
no JAX, so a GPU machine without JAX runs it (skipping conftest.py):

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

Tolerance: exact (sorted multiset with ids, and every counter).
"""

import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import bundled_paths, load_table
from particle_simulation_tpu_torch.ops.kernels import build
from particle_simulation_tpu_torch.ops.kernels.worklog import (
    mobility_phase_worklog, mobility_phase_worklog_plain, worklog_phase,
)
from particle_simulation_tpu_torch.ops.step import grid_phase
from particle_simulation_tpu_torch.runtime import multiset_with_ids
from particle_simulation_tpu_torch.state import setup_particles

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


def test_work_log_overflow_is_flagged(dev):
    cfg = SimConfig(**CHURN, worklog_rows=1)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    out, info = mobility_phase_worklog(st, 0, table, cfg, cfg.poisson_timestep)
    assert info["overflow"] and out.n <= cfg.capacity


def test_done_log_overflow_is_flagged(dev):
    """3,000 electrons of the const churn end the phase 3,078 strong (the
    plain version at a larger capacity): the done log passes a capacity of
    3,000 while the work logs (512 rows of 128) hold every pass."""
    cfg = SimConfig(**dict(CHURN, capacity=3000), worklog_rows=512)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    out, info = mobility_phase_worklog(st, 0, table, cfg, cfg.poisson_timestep)
    assert info["overflow"] and out.n == cfg.capacity
    assert info["removed"] == cfg.init_n + info["added"] - cfg.capacity
    assert bool((out.status == -1).all())


@pytest.mark.parametrize("bad", [dict(spawn_depth=5), dict(rng_rounds=12)])
def test_unbuilt_variants_raise(dev, bad):
    cfg = SimConfig(**CHURN, **bad)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    with pytest.raises(ValueError):
        mobility_phase_worklog(st, 0, table, cfg, cfg.poisson_timestep)


def test_table_on_the_wrong_device_raises(dev):
    cfg = SimConfig(**CHURN)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    with pytest.raises(ValueError, match="table"):
        mobility_phase_worklog(st, 0, load_table(device="cpu"), cfg,
                               cfg.poisson_timestep)
