"""The port's float64 oracle against its own float32 path
(tests/test_oracle.py on the port).

With the constant cross-section table the collision decisions do not
depend on the float precision (the draw is integer-derived and the
chances do not depend on the energy), so f32 and f64 runs agree exactly
on the population: n, added and the id multiset.  With the sine table the
trajectories agree to float32 resolution over a short run, within
tests/test_oracle.py's tolerances.
"""

import numpy as np
import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import bundled_paths
from particle_simulation_tpu_torch.runtime import run_pic

CONST_CFG = SimConfig(
    init_n=200, capacity=20_000, poisson_steps=3, poisson_timestep=6,
    grid_size=(32, 32, 32), cross_section_path=bundled_paths()[1],
)
SINE_CFG = SimConfig(
    init_n=100, capacity=1000, poisson_steps=2, poisson_timestep=8,
    grid_size=(32, 32, 32),  # sine table: no collisions while cold
)


def _run(cfg):
    return run_pic(cfg, print_header=False, device="cpu")


@pytest.mark.parametrize("scheduler", ["naive", "sync"])
def test_f64_oracle_const_table_exact_population(scheduler):
    cfg = CONST_CFG.replace(scheduler=scheduler)
    r32 = _run(cfg)
    r64 = _run(cfg.replace(precision="f64"))
    assert r64.state.pos.dtype == r64.state.vel.dtype == torch.float64
    assert r64.state.acc.dtype == torch.float32
    assert [m.n for m in r32.steps] == [m.n for m in r64.steps]
    assert [m.added for m in r32.steps] == [m.added for m in r64.steps]
    assert sum(m.added for m in r64.steps) > 0
    n = r32.final_n
    for f in ("id_hi", "id_lo"):
        np.testing.assert_array_equal(
            np.sort(getattr(r32.state, f)[:n].numpy()),
            np.sort(getattr(r64.state, f)[:n].numpy()))


def test_f64_oracle_dynamic_f32_equals_f64_population():
    """The f32 work-log engine (its plain version here) against the f64
    ``sync`` oracle: the same population."""
    r32 = _run(CONST_CFG.replace(scheduler="dynamic"))
    r64 = _run(CONST_CFG.replace(scheduler="sync", precision="f64"))
    assert [(m.n, m.added) for m in r32.steps] == \
        [(m.n, m.added) for m in r64.steps]


@pytest.mark.parametrize("scheduler", ["naive", "sync"])
def test_f64_oracle_positions_close(scheduler):
    cfg = SINE_CFG.replace(scheduler=scheduler)
    r32 = _run(cfg)
    r64 = _run(cfg.replace(precision="f64"))
    n = r32.final_n
    assert n == r64.final_n
    np.testing.assert_allclose(r32.state.vel[:n].numpy(),
                               r64.state.vel[:n].numpy(),
                               rtol=2e-5, atol=1e-12)
    np.testing.assert_allclose(r32.state.pos[:n].numpy(),
                               r64.state.pos[:n].numpy(), rtol=1e-5)
    # float64 is a different computation, not float32 widened
    assert not np.array_equal(r32.state.pos[:n].numpy().astype(np.float64),
                              r64.state.pos[:n].numpy())


def test_unit_test_f64_runs_the_plain_cadences(capsys):
    """``testing.run_unit_test`` under f64 compares the plain cadences
    only (the engines run float32 only)."""
    from particle_simulation_tpu_torch.testing import run_unit_test

    assert run_unit_test(CONST_CFG.replace(precision="f64"), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines
            if ": success (" in line] == ["sync", "naive"]
