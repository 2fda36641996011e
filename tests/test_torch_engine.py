"""The fused engines' one host side (ops/kernels/engine.py) on the CPU:
the check before a launch, for both engines, the contract that the
benchmark's harness reads (the launch entry points and their counters),
and the outputs a phase keeps between launches: when it may take one and
how far the kernel clears it."""

import ast
import inspect

import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import (
    bundled_paths, load_table,
)
from particle_simulation_tpu_torch.ops import population, step
from particle_simulation_tpu_torch.ops.kernels import engine, push_mcc, worklog
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


def _kept(c=64, mark=20):
    """A kept output of ``c`` rows whose rows from ``mark`` on hold zeros,
    handed out as aliases: (the Kept, the caller's state)."""
    out = engine.empty_state(c, "cpu")
    for t in out[:6]:
        t.zero_()
        t[:mark] = 7
    kept = engine.Kept(out, mark, engine.versions(out))
    return kept, out._replace(**{f: getattr(out, f).detach()
                                 for f in out._fields[:6]}, n=mark)


# what a caller does with the state a phase handed out -> what it holds
def _nothing(st):
    return ()


def _view(st):
    return (st.pos[:3],)


def _reinterpreted(st):
    return (st.status.view(torch.float32),)


def _own_input(st):
    """The next phase's input: the state after its field phase, a new
    ``acc`` and the other tensors its own."""
    return (st._replace(acc=torch.zeros_like(st.acc)),)


def _append_children(st):
    """Five children of the first rows appended in place at [n, n+5)."""
    p = step.state_to_particles(st, 5)
    population.append_children(st, torch.ones(5, dtype=torch.bool),
                               p._replace(status=torch.full(
                                   (5,), 3, dtype=torch.int32)))
    return ()


def _index_put(st):
    st.id_lo.index_put_((torch.tensor([30]),),
                        torch.tensor([1], dtype=torch.int32))
    return ()


def _copy(st):
    st.vel.copy_(torch.ones_like(st.vel))
    return ()


# case -> (what the caller does, the phase's capacity and device, how far
# the phase clears while the caller holds what it kept, and after)
REUSE = {
    "untouched": (_nothing, 64, "cpu", 20, 20),
    "view_held": (_view, 64, "cpu", None, 20),
    "reinterpreted_view_held": (_reinterpreted, 64, "cpu", None, 20),
    "own_input": (_own_input, 64, "cpu", None, 20),
    "append_children": (_append_children, 64, "cpu", 64, 64),
    "index_put_": (_index_put, 64, "cpu", 64, 64),
    "copy_": (_copy, 64, "cpu", 64, 64),
    "other_capacity": (_nothing, 128, "cpu", None, None),
    "other_device": (_nothing, 64, "meta", None, None),
}


@pytest.mark.parametrize("case", list(REUSE))
def test_reuse_decision(case):
    """A kept output is taken only where nothing outside the engine holds
    its storage (a view, the phase's own input), and cleared to the
    capacity where a torch in-place write reached it since it was handed
    out (``append_children``'s ``index_put_``, a ``copy_``), else to its
    mark; another capacity or device takes a fresh one (None)."""
    act, capacity, device, held_to, then_to = REUSE[case]
    kept, st = _kept()
    held = act(st)
    del st
    assert engine.clear_to(kept, capacity, device) == held_to
    del held
    assert engine.clear_to(kept, capacity, device) == then_to


class _Kernel:
    """A phase kernel on CPU tensors: the plain version's output written
    to the buffers ``Phase.buffers`` gave, the rows from its population to
    ``clear_to`` zeroed, the result words that carry its population; each
    launch's ``clear_to`` recorded."""

    def __init__(self, phase, taken, table, cfg):
        self.phase, self.taken, self.table, self.cfg = phase, taken, table, cfg
        self.clear_to = []
        self.input = None  # (state, Poisson step) of the next launch

    def call(self, symbol, *args):
        bufs, to = self.taken[-1], args[14]
        state, step_index = self.input
        p, _ = self.phase.engine.plain(state, step_index, self.table,
                                       self.cfg, self.cfg.poisson_timestep)
        end = max(p.n, to)
        for o, x in zip(bufs.out[:6], p[:6]):
            o[:p.n] = x[:p.n]
            o[p.n:end] = 0
        bufs.result.copy_(torch.tensor(
            {"worklog": [p.n, 0, 0, 1, 0, 0, 1],
             "staged": [p.n, p.n, 0, 1, 0, 0, 0, 1]}[self.phase.engine.name]))
        self.clear_to.append(to)


@pytest.mark.parametrize("engine_name", list(ENGINES))
def test_kept_outputs_in_turn(engine_name, monkeypatch):
    """Through ``Phase.run_kept`` with the kernel's contract played on the
    CPU: a caller that drops each state gets the two kept outputs in turn,
    each cleared to its mark and counted in ``out_reuses``; a caller that
    holds them gets fresh ones; every output equals the plain version's
    in every row."""
    from types import SimpleNamespace

    from particle_simulation_tpu_torch.ops.kernels import build

    phase, scheduler = ENGINES[engine_name]
    cfg = SimConfig(**SMALL, scheduler=scheduler, spawn_depth=2)
    table = load_table(bundled_paths()[1], "cpu")
    taken = []
    buffers = phase.buffers
    monkeypatch.setattr(phase, "buffers", lambda *a: (
        taken.append(buffers(*a)) or taken[-1]))
    kernel = _Kernel(phase, taken, table, cfg)
    monkeypatch.setattr(build, "load", lambda: kernel)
    monkeypatch.setattr(engine, "check_buffers", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(phase, "kept", {})
    monkeypatch.setattr(phase, "out_reuses", 0)

    def run(st, i):
        kernel.input = (st, i)
        out, _ = phase.run_kept(st, i, table, cfg, cfg.poisson_timestep)
        want, _ = phase.engine.plain(st, i, table, cfg, cfg.poisson_timestep)
        assert out.n == want.n and all(
            torch.equal(x.view(torch.int32), y.view(torch.int32))
            for x, y in zip(out[:6], want[:6]))
        return out

    c = cfg.capacity
    a = run(setup_particles(cfg, device="cpu"), 0)
    b = run(a, 1)              # a is the input: a fresh output
    marks = [a.n, b.n]
    del a
    d = run(b, 2)              # a's output, cleared to its mark
    del b
    view = d.pos[:3]
    e = run(d, 3)              # b's output, cleared to its mark
    f = run(e, 4)              # d (a view) and e held: a fresh output
    assert kernel.clear_to == [c, c, marks[0], marks[1], c]
    assert phase.out_reuses == 2
    assert len(phase.kept[(torch.device("cpu"), 0)].outs) == 2
    del view, d, e, f
