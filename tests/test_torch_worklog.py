"""The work-log engine module (ops/kernels/worklog.py) on the CPU: its
plain version against the JAX package's Pallas engine itself (interpret
mode, as tests/test_worklog.py runs it), the device dispatch and the record
layout.  Kernel-vs-plain on the card: tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particle_simulation_tpu as J
from particle_simulation_tpu.cross_section import bundled_paths
from particle_simulation_tpu.cross_section import load_table as j_load
from particle_simulation_tpu.ops.step import poisson_step as j_step
from particle_simulation_tpu.runtime import sorted_particle_array as j_sorted
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch.cross_section import load_table
from particle_simulation_tpu_torch.ops.kernels import build
from particle_simulation_tpu_torch.ops.kernels.push_mcc import (
    _INF_START, _STAMP_BITS, _SUS_BASE, stack_to_state, state_to_stack,
)
from particle_simulation_tpu_torch.ops.kernels.worklog import (
    LOOKBACK_REGIONS, RESULT, TILE, mobility_phase_worklog,
    mobility_phase_worklog_plain, phase_buffers, scratch_shapes,
    work_capacity, worklog_phase,
)
from particle_simulation_tpu_torch.ops.step import grid_phase, poisson_step
from particle_simulation_tpu_torch.runtime import (
    multiset_with_ids, sorted_particle_array,
)
from particle_simulation_tpu_torch.state import setup_particles

BASE = dict(init_n=200, capacity=4096, grid_size=(16, 16, 16),
            poisson_timestep=6)


def test_plain_matches_jax_dynamic_engine():
    """One case against JAX ``dynamic`` itself: the Pallas work-log engine
    in interpret mode (about a minute of compilation on one CPU)."""
    jcfg = J.SimConfig(**BASE, scheduler="dynamic", kernel_sublanes=8)
    jt = j_load(bundled_paths()[1])
    js = J.setup_particles(jcfg)
    cfg = SimConfig(**BASE, scheduler="dynamic")
    t = load_table(bundled_paths()[1], "cpu")
    ts = setup_particles(cfg, device="cpu")
    for s in range(2):
        js, jm = j_step(js, jnp.uint32(s), jt, jcfg)
        ts, tm = poisson_step(ts, s, t, cfg)
        for k in tm:
            assert int(jm[k]) == int(tm[k]), (s, k)
        np.testing.assert_array_equal(j_sorted(js), sorted_particle_array(ts))
        j_numpy = {f: np.asarray(getattr(js, f)) for f in interop.FIELDS}
        np.testing.assert_array_equal(
            multiset_with_ids(interop.state_from_numpy(j_numpy, "cpu")),
            multiset_with_ids(ts),
        )


def test_cpu_state_takes_the_plain_version():
    cfg = SimConfig(**BASE, scheduler="dynamic")
    t = load_table(bundled_paths()[1], "cpu")
    st = grid_phase(setup_particles(cfg, device="cpu"), cfg)
    before = worklog_phase.launches
    a, ai = mobility_phase_worklog(st, 0, t, cfg, 6)
    b, bi = mobility_phase_worklog_plain(st, 0, t, cfg, 6)
    assert worklog_phase.launches == before
    assert ai == bi and ai["added"] > 0
    assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
    assert mobility_phase_worklog.self_compacting


def test_other_devices_raise():
    cfg = SimConfig(**BASE, scheduler="dynamic")
    st = setup_particles(cfg, device="meta")
    with pytest.raises(ValueError, match="no work-log engine"):
        mobility_phase_worklog(st, 0, None, cfg, 6)


def test_record_stack_round_trip():
    st = setup_particles(SimConfig(**BASE), device="cpu")
    st = st._replace(acc=torch.randn(st.acc.shape))
    stack = state_to_stack(st)
    assert stack.shape == (12, BASE["capacity"]) and stack.dtype == torch.int32
    assert torch.equal(stack[9], st.status)
    back = stack_to_state(stack, st.n)
    assert back.n == st.n
    assert all(torch.equal(x, y) for x, y in zip(back[:6], st[:6]))


def test_work_capacity():
    assert work_capacity(SimConfig(), 2_000_000) == 1_000_000
    assert work_capacity(SimConfig(worklog_rows=16), 2_000_000) == 2048


def test_build_flags_keep_parity():
    flags = build.nvcc_flags()
    assert f"-DPST_WORKLOG_TILE={TILE}" in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert not any("fast" in f for f in flags)
    assert f"-DPST_SUS_BASE={_SUS_BASE}" in flags
    assert f"-DPST_STAMP_BITS={_STAMP_BITS}" in flags
    assert f"-DPST_INF_START={_INF_START}" in flags
    assert "-DPST_N_STEPS=10000" in flags
    # the kernel's look-back regions and result words are the wrapper's
    assert f"-DPST_WORKLOG_REGIONS={LOOKBACK_REGIONS}" in flags
    assert f"-DPST_WORKLOG_RESULT_WORDS={len(RESULT)}" in flags


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("t_steps", [6, 100, 1000])
@pytest.mark.parametrize("capacity,rows,w_cap,largest", [
    (2_000_000, 0, 1_000_000, 2_000_000),  # the main path
    (4096, 0, 2048, 4096),
    (4096, 64, 8192, 8192),            # a work log larger than the capacity
    (1000, 0, 500, 1000),
])
def test_scratch_shapes(capacity, rows, w_cap, largest, depth, t_steps):
    """The look-back words hold three rotating regions, each a ticket and a
    done and a work word per tile of the largest pass; the result holds the
    seven phase words.  Neither t_steps (the passes a phase may take) nor
    the spawn depth sizes anything."""
    cfg = SimConfig(worklog_rows=rows, spawn_depth=depth,
                    poisson_timestep=t_steps)
    assert work_capacity(cfg, capacity) == w_cap
    tiles = -(-largest // TILE)
    assert (tiles - 1) * TILE < largest <= tiles * TILE
    assert scratch_shapes(cfg, capacity) == {
        "logs": (2, 12, w_cap),
        "lookback": (LOOKBACK_REGIONS, 1 + 2 * tiles),
        "result": (7,),
    }
    assert LOOKBACK_REGIONS == 3 and len(RESULT) == 7


def _cpu_buffers():
    cfg = SimConfig(**BASE, scheduler="dynamic")
    st = setup_particles(cfg, device="cpu")
    return cfg, st, phase_buffers(st, cfg)


@pytest.mark.parametrize("bad,why", [
    (lambda st, b: (st, b), "on cpu"),
    (lambda st, b: (st, b._replace(logs=b.logs.float())), "dtype"),
    (lambda st, b: (st, b._replace(result=b.result.int())), "dtype"),
    (lambda st, b: (st._replace(status=st.status.long()), b), "dtype"),
    (lambda st, b: (st, b._replace(
        lookback=b.lookback.t().contiguous().t())), "not contiguous"),
    (lambda st, b: (st._replace(pos=st.pos.t().contiguous().t()), b),
     "not contiguous"),
    (lambda st, b: (st, b._replace(logs=b.logs[:, :, :-1])), "shape"),
])
def test_phase_wrapper_checks_buffers_before_any_launch(bad, why):
    """No library is given: a check that let the call through would fail
    on it, not raise ValueError."""
    cfg, st, bufs = _cpu_buffers()
    st, bufs = bad(st, bufs)
    before = worklog_phase.launches
    with pytest.raises(ValueError, match=why):
        worklog_phase(None, st, bufs, load_table(bundled_paths()[1], "cpu"),
                      cfg, 0, 6)
    assert worklog_phase.launches == before
