"""The staged CUDA kernel (csrc/staged.cu) against its plain PyTorch version,
on the card.

These tests need a CUDA GPU and nvcc and skip elsewhere.  This file imports
no JAX, so a GPU machine without JAX runs it (skipping conftest.py):

    python -m pytest tests/test_torch_staged_kernels.py -m cuda --noconftest

Tolerance: exact (the record stack after every pass, the sorted multiset
with ids, and every counter).
"""

import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import bundled_paths, load_table
from particle_simulation_tpu_torch.ops.kernels import build
from particle_simulation_tpu_torch.ops.kernels import push_mcc as pm
from particle_simulation_tpu_torch.ops.step import grid_phase, poisson_step
from particle_simulation_tpu_torch.runtime import multiset_with_ids
from particle_simulation_tpu_torch.state import setup_particles

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


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("mode,rounds", [("block2", 13), ("perstep", 20)])
def test_pass_matches_plain(dev, depth, mode, rounds):
    """Pass by pass from the same stack: the whole stack and the totals."""
    cfg = SimConfig(**CHURN, spawn_depth=depth, rng_mode=mode,
                    rng_rounds=rounds)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    lib = build.load()
    scratch = pm._Scratch(st.capacity, depth, dev)
    k_stack = pm.state_to_stack(st)
    p_stack = k_stack.clone()
    n, passes = st.n, 0
    while True:
        k = pm.staged_pass(lib, k_stack, n, scratch, table, cfg, 0,
                           cfg.poisson_timestep)
        p = pm.staged_pass_plain(p_stack, n, table, cfg, 0,
                                 cfg.poisson_timestep)
        passes += 1
        assert k == p, (passes, k, p)
        assert torch.equal(k_stack, p_stack), passes
        n = k.n
        if not (k.suspended or k.appended):
            break
    assert passes > 1 and n > st.n


def _steps(cfg, table, dev, steps):
    """Kernel, plain host loop and the work-log kernel from the same state
    each Poisson step; returns the kernel's per-step info."""
    dyn = cfg.replace(scheduler="dynamic")
    infos = []

    def kernel(*args):
        state, info = pm.mobility_phase_dynamic(*args)
        infos.append(info)
        return state, info

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
    """At capacity 16,384 the host loop reclaims before appending and equals
    the work-log kernel (whose done log holds live records only)."""
    cfg = SimConfig(**dict(CHURN, capacity=16384))
    infos = _steps(cfg, load_table(bundled_paths()[1], dev), dev, steps=3)
    assert sum(i["reclaimed"] for i in infos) > 0


def test_launch_counter_counts_passes(dev):
    cfg = SimConfig(**CHURN)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    before = pm.staged_pass.launches
    pm.mobility_phase_dynamic(st, 0, table, cfg, cfg.poisson_timestep)
    assert pm.staged_pass.launches - before > 1


@pytest.mark.parametrize("bad", [dict(spawn_depth=5), dict(rng_rounds=12)])
def test_unbuilt_variants_raise(dev, bad):
    cfg = SimConfig(**CHURN, **bad)
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    with pytest.raises(ValueError):
        pm.mobility_phase_dynamic(st, 0, table, cfg, cfg.poisson_timestep)


def test_table_on_the_wrong_device_raises(dev):
    cfg = SimConfig(**CHURN)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    with pytest.raises(ValueError, match="table"):
        pm.mobility_phase_dynamic(st, 0, load_table(device="cpu"), cfg,
                                  cfg.poisson_timestep)
