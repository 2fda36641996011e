"""The fused engines' one host side (ops/kernels/engine.py) on the CPU:
the check before a launch, for both engines, and the contract that the
benchmark's harness reads (the launch entry points and their counters)."""

import ast
import inspect

import pytest

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import (
    bundled_paths, load_table,
)
from particle_simulation_tpu_torch.ops.kernels import push_mcc, worklog
from particle_simulation_tpu_torch.state import setup_particles

SMALL = dict(init_n=200, capacity=4096, grid_size=(16, 16, 16),
             poisson_timestep=6)
ENGINES = {"worklog": (worklog.worklog_phase, "dynamic"),
           "staged": (push_mcc.staged_phase, "dynamic_old")}
# (engine, a fault of the buffers or the state, what the error names)
FAULTS = [
    ("worklog", lambda st, b: (st, b), "on cpu"),
    ("worklog", lambda st, b: (st, b._replace(logs=b.logs.float())),
     "dtype"),
    ("worklog", lambda st, b: (st, b._replace(result=b.result.int())),
     "dtype"),
    ("worklog", lambda st, b: (st._replace(status=st.status.long()), b),
     "dtype"),
    ("worklog", lambda st, b: (st, b._replace(
        lookback=b.lookback.t().contiguous().t())), "not contiguous"),
    ("worklog", lambda st, b: (st._replace(pos=st.pos.t().contiguous().t()),
                               b), "not contiguous"),
    ("worklog", lambda st, b: (st, b._replace(logs=b.logs[:, :, :-1])),
     "shape"),
    ("staged", lambda st, b: (st, b), "on cpu"),
    ("staged", lambda st, b: (st, b._replace(stage=b.stage.float())),
     "dtype"),
    ("staged", lambda st, b: (st, b._replace(result=b.result.int())),
     "dtype"),
    ("staged", lambda st, b: (st, b._replace(out=b.out._replace(
        status=b.out.status.long()))), "dtype"),
    ("staged", lambda st, b: (st, b._replace(stage=b.stage[:, :1])),
     "shape"),
    ("staged", lambda st, b: (st, b._replace(stacks=b.stacks[:, :, :-1])),
     "shape"),
    ("staged", lambda st, b: (st, b._replace(list=b.list[:, ::2])), "shape"),
    ("staged", lambda st, b: (st, b._replace(
        lookback=b.lookback.t().contiguous().t())), "not contiguous"),
    ("staged", lambda st, b: (st._replace(vel=st.vel.t().contiguous().t()),
                              b), "not contiguous"),
]


@pytest.mark.parametrize("engine,bad,why", FAULTS)
def test_phase_checks_buffers_before_any_launch(engine, bad, why):
    """No library is given: a check that let the call through would fail
    on it, not raise ValueError."""
    phase, scheduler = ENGINES[engine]
    cfg = SimConfig(**SMALL, scheduler=scheduler, spawn_depth=2)
    st = setup_particles(cfg, device="cpu")
    st, bufs = bad(st, phase.buffers(st, cfg))
    before = phase.launches
    with pytest.raises(ValueError, match=why):
        phase(None, st, bufs, load_table(bundled_paths()[1], "cpu"), cfg, 0,
              6)
    assert phase.launches == before


def test_harness_contract():
    """What the benchmark's harness reads: both launch entry points carry
    their counters, ``reclaims`` on the staged one only (the harness counts
    what ``hasattr`` finds), and the work-log engine's module does not
    import the staged engine's."""
    for name in ("launches", "passes", "open_launches", "general_launches",
                 "last"):
        assert hasattr(worklog.worklog_phase, name)
        assert hasattr(push_mcc.staged_phase, name)
    assert not hasattr(worklog.worklog_phase, "reclaims")
    assert hasattr(push_mcc.staged_phase, "reclaims")
    tree = ast.parse(inspect.getsource(worklog))
    imported = [node.module or "" for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)]
    imported += [alias.name for node in ast.walk(tree)
                 if isinstance(node, (ast.Import, ast.ImportFrom))
                 for alias in node.names]
    assert not any("push_mcc" in m for m in imported), imported
