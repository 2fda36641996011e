"""The port's scheduler-equivalence test (``testing.run_unit_test``, the
reference's runUnitTest) against the JAX package's: the same printed lines
and the same boolean, on success and on each kind of failure, at the size
of tests/test_schedulers.py (2 Poisson steps).  JAX runs ``naive`` against
its ``sync`` base (its ``dynamic`` in interpret mode costs a minute); the
port runs its four schedulers against its own ``sync``."""

import dataclasses

import pytest
import torch

from particle_simulation_tpu import testing as jtesting
from particle_simulation_tpu_torch import testing

from test_torch_runtime import CFG, jax_config, printed

UNIT = CFG.replace(poisson_steps=2)


def test_default_schedulers_all_succeed():
    ok, out = printed(testing.run_unit_test, UNIT, device="cpu")
    assert ok
    lines = out.splitlines()
    successes = [l for l in lines if ": success (" in l]
    assert [l.split(":")[0] for l in successes] == [
        "dynamic", "sync", "dynamic_old", "naive"]
    n = lines[0].rsplit(" ", 1)[1]
    assert all(l.endswith(f"({n})") for l in successes)


def test_lines_match_jax():
    ok, out = printed(testing.run_unit_test, UNIT, schedulers=["naive"],
                      device="cpu")
    ref_ok, ref_out = printed(jtesting.run_unit_test, jax_config(UNIT),
                              schedulers=["naive"])
    assert ok and ref_ok
    assert out == ref_out


def _final_n_off_by_one(run_pic):
    def wrapped(cfg, *args, **kw):
        run = run_pic(cfg, *args, **kw)
        if cfg.scheduler == "naive":
            run = dataclasses.replace(run, final_n=run.final_n + 1)
        return run
    return wrapped


def _first_particle_moved(run_pic, shift):
    def wrapped(cfg, *args, **kw):
        run = run_pic(cfg, *args, **kw)
        if cfg.scheduler == "naive":
            run = dataclasses.replace(run, state=shift(run.state))
        return run
    return wrapped


def _shift_torch(state):
    pos = state.pos.clone()
    pos[0, 0] += torch.tensor(1e-3, dtype=torch.float32)
    return state._replace(pos=pos)


def _shift_jax(state):
    import numpy as np

    return state._replace(pos=state.pos.at[0, 0].add(np.float32(1e-3)))


@pytest.mark.parametrize("fault", ["final_n", "particle"])
def test_failures_match_jax(fault, monkeypatch):
    """A scheduler whose final n or whose particles differ from the base:
    the same lines as the JAX package's and a False result."""
    if fault == "final_n":
        port, ref = (_final_n_off_by_one(testing.run_pic),
                     _final_n_off_by_one(jtesting.run_pic))
    else:
        port = _first_particle_moved(testing.run_pic, _shift_torch)
        ref = _first_particle_moved(jtesting.run_pic, _shift_jax)
    monkeypatch.setattr(testing, "run_pic", port)
    monkeypatch.setattr(jtesting, "run_pic", ref)
    ok, out = printed(testing.run_unit_test, UNIT, schedulers=["naive"],
                      device="cpu")
    ref_ok, ref_out = printed(jtesting.run_unit_test, jax_config(UNIT),
                              schedulers=["naive"])
    assert not ok and not ref_ok
    assert "naive: failure" in out
    assert out == ref_out
