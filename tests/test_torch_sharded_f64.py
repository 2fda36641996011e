"""The sharded path in the float64 oracle mode (``precision="f64"``):
two gloo ranks on the CPU, replicated field (the float64 gather, as JAX's
``field_acceleration`` takes it), against the single-process port and the
JAX package's ``run_pic_sharded`` under ``jax_enable_x64`` on
``make_mesh(2)``: the sorted live rows with ids (float64 words included)
and the per-step history, exact.  ``grid_mode="slab"`` refuses f64, as in
JAX."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from particle_simulation_tpu.parallel import sharded as jsharded
from particle_simulation_tpu_torch import interop
from particle_simulation_tpu_torch.parallel import launch, sharded
from particle_simulation_tpu_torch.runtime import multiset_with_ids, run_pic

from test_torch_sharded_jax import CFG, jax_config, rows_of

F64 = CFG.replace(precision="f64")
D = 2


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def port():
    """Rank 0's results for ``naive`` and ``sync`` at two gloo ranks."""
    scs = [{"config": F64.replace(scheduler=s)} for s in ("naive", "sync")]
    res = launch.run(sharded.run_scenarios, D, args=(scs,), device="cpu",
                     timeout_s=240)
    return res[0]


def test_sharded_f64_equals_jax_and_single_process(port):
    with x64():
        state, want_hist = jsharded.run_pic_sharded(jax_config(F64),
                                                    jsharded.make_mesh(D))
        arrays = {f: np.asarray(getattr(state, f))
                  for f in ("pos", "vel", "acc", "status", "id_hi", "id_lo")}
    assert arrays["pos"].dtype == np.float64
    want = rows_of(arrays)
    # the global workload in one process: D x init_n seeded as the ranks'
    # slot ranges concatenated
    single = run_pic(F64.replace(init_n=D * F64.init_n,
                                 capacity=D * F64.capacity),
                     print_header=False, device="cpu")
    for got in port:
        assert got["history"] == want_hist
        assert got["field_paths"]["f64"] == F64.poisson_steps
        assert got["live"]["pos"].dtype == np.float64
        np.testing.assert_array_equal(rows_of(got["live"]), want)
        assert got["final_n"] == single.final_n
    st = interop.state_from_numpy(
        {**port[0]["live"], "n": len(port[0]["live"]["status"])}, "cpu",
        torch.float64)
    np.testing.assert_array_equal(multiset_with_ids(st),
                                  multiset_with_ids(single.state))


def test_slab_refuses_f64():
    with pytest.raises(ValueError, match="f32 precision"):
        sharded.use_slab(F64.replace(grid_mode="slab", bbox_subgrid=64), D)
