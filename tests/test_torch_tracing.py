"""The port's spans (``utils.profiling.span``): nothing while no profiler
records, ``record_function`` annotations named ``pst.*`` in the trace of
one that does, nested as the layers nest, and the same results either
way.

The CPU cases run ``runtime.run_pic`` on the plain engines, whose
mobility phase is the outer ``pst.mobility`` alone; the card case adds the
engines' buffers, launch and readback and the per-step synchronise.  This
file imports no JAX, so a GPU machine without JAX runs the card case:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest
"""

import json
import os

import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import bundled_paths
from particle_simulation_tpu_torch.ops import grid as grid_ops
from particle_simulation_tpu_torch.runtime import multiset_with_ids, run_pic
from particle_simulation_tpu_torch.utils import profiling

# every span of the program, with the span that encloses it
PARENT = {
    "pst.run": None,
    "pst.setup": "pst.run",
    **{f"pst.setup.{p}": "pst.setup"
       for p in ("zero", "ids", "pos", "vel", "select", "launch")},
    "pst.step": "pst.run",
    "pst.sync": "pst.run",
    "pst.field": "pst.step",
    **{f"pst.field.{p}": "pst.field"
       for p in ("window", "window_readback", "deposit", "stencil",
                 "fits_readback", "gather", "store")},
    "pst.mobility": "pst.step",
    **{f"pst.mobility.{p}": "pst.mobility"
       for p in ("alloc", "launch", "readback")},
}
# the spans only a CUDA state runs: the engines' and the synchronise
CARD_ONLY = {"pst.sync", "pst.mobility.alloc", "pst.mobility.launch",
             "pst.mobility.readback"}
# the set-up's parts: the plain twin's on the CPU, the kernel's on the card
PLAIN_SETUP = {f"pst.setup.{p}"
               for p in ("zero", "ids", "pos", "vel", "select")}
CARD_SETUP = {"pst.setup.launch"}
# what each field path leaves out of the field phase's spans
NOT_ON_PATH = {"subgrid": set(), "window_fallback": set(),
               "full": {"pst.field.window", "pst.field.window_readback"}}
# what the card's subgrid path (the kernel chain, which writes acc itself
# after one readback) leaves out besides
NOT_ON_CARD_SUBGRID = {"pst.field.stencil", "pst.field.fits_readback",
                       "pst.field.store"}
# the bbox_subgrid that takes each path on the 32^3 grid: the seed cube
# spans every cell, which a 32-cell window holds and an 8-cell one does not
SUBGRID = {"subgrid": 32, "window_fallback": 8, "full": 0}


def _config(scheduler="dynamic", path="subgrid", **kw):
    return SimConfig(
        init_n=300, capacity=20_000, poisson_steps=3, poisson_timestep=6,
        grid_size=(32, 32, 32), cross_section_path=bundled_paths()[1],
        scheduler=scheduler, bbox_subgrid=SUBGRID[path], **kw)


def _spans(log_dir):
    """The ``pst.*`` spans of the one Chrome trace in ``log_dir``:
    [(name, start, end, parent name)], the parent the innermost ``pst.*``
    span around it on its thread."""
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    marks = sorted(
        ((e["tid"], float(e["ts"]), -float(e["dur"]), e["name"])
         for e in events if e.get("ph") == "X"
         and e.get("cat") == "user_annotation"
         and e["name"].startswith("pst.")))
    out, stack = [], []
    for tid, s, neg_dur, n in marks:
        e = s - neg_dur
        while stack and (stack[-1][0] != tid or stack[-1][2] < e):
            stack.pop()
        out.append((n, s, e, stack[-1][3] if stack else None))
        stack.append((tid, s, e, n))
    return out


def _traced_run(tmp_path, cfg, device="cpu"):
    """``run_pic`` under ``profiling.trace``: (its RunData, its spans)."""
    log_dir = str(tmp_path / "trace")
    grid_ops.field_counts.reset()
    with profiling.trace(log_dir):
        run = run_pic(cfg, print_header=False, device=device)
    return run, _spans(log_dir)


def _counters(run):
    return [(m.n, m.added, m.removed, bool(m.overflow), m.pushes)
            for m in run.steps]


def test_span_off_makes_no_record_function(monkeypatch):
    """With no profiler a span is the shared null context: a whole run
    never builds a ``record_function``."""

    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("pst.x") is profiling.span("pst.y")
    run = run_pic(_config(), print_header=False, device="cpu")
    assert len(run.steps) == 3


def test_the_profilers_flag_is_pinned():
    """The gate ``span`` reads is ``torch.autograd.profiler.
    _is_profiler_enabled``: False with no profiler, True while a
    ``torch.profiler`` session records (entered as a context or by
    ``start``, as the benchmark does), False again after."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    assert isinstance(profiling.span("pst.x"), type(profiling._OFF))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert flag() is True
        assert isinstance(profiling.span("pst.x"),
                          torch.profiler.record_function)
    assert flag() is False
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert flag() is True
    finally:
        prof.stop()
    assert flag() is False


@pytest.mark.parametrize("path", sorted(SUBGRID))
@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
def test_trace_holds_every_span_nested(tmp_path, scheduler, path):
    """One traced CPU ``run_pic`` exports every span the CPU runs on this
    field path, each inside the span the layers put it in: one
    ``pst.step`` a Poisson step, and the field phase's readback spans as
    many as ``field_counts.readbacks`` (two a subgrid field phase)."""
    cfg = _config(scheduler, path)
    run, spans = _traced_run(tmp_path, cfg)
    steps = len(run.steps)
    assert steps == cfg.poisson_steps
    assert grid_ops.field_counts.paths[path] == steps
    want = (set(PARENT) - CARD_ONLY - CARD_SETUP - NOT_ON_PATH[path]
            - {"pst.setup.vel"})
    assert {n for n, *_ in spans} == want
    for n, _, _, parent in spans:
        assert parent == PARENT[n], (n, parent)
    count = {n: sum(1 for s in spans if s[0] == n) for n in want}
    assert count["pst.run"] == count["pst.setup"] == 1
    for n in want - {"pst.run", "pst.setup"} - {
            k for k in want if k.startswith("pst.setup.")}:
        assert count[n] == steps, n
    readbacks = (count.get("pst.field.window_readback", 0)
                 + count["pst.field.fits_readback"])
    assert readbacks == grid_ops.field_counts.readbacks
    assert readbacks == (steps if path == "full" else 2 * steps)


def test_thermal_start_has_a_velocity_span(tmp_path):
    """``init_vth`` adds ``pst.setup.vel`` between the positions and the
    selection, inside ``pst.setup``."""
    _, spans = _traced_run(tmp_path, _config(init_vth=2e5))
    setup = [s for s in spans if s[3] == "pst.setup"]
    assert [s[0] for s in sorted(setup, key=lambda s: s[1])] == [
        "pst.setup.zero", "pst.setup.ids", "pst.setup.pos",
        "pst.setup.vel", "pst.setup.select"]


@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
def test_spans_change_no_result(tmp_path, scheduler):
    """A run with the spans recording equals one without: the final
    multiset with ids and every step's counters."""
    cfg = _config(scheduler)
    off = run_pic(cfg, print_header=False, device="cpu")
    on, spans = _traced_run(tmp_path, cfg)
    assert spans
    assert _counters(on) == _counters(off)
    assert (multiset_with_ids(on.state) == multiset_with_ids(off.state)).all()


def test_span_cost_probe_runs(capsys):
    """``probes/span_cost.py`` at its CPU size: the off cost of a span and
    the field and mobility times with the spans on and off, in turns."""
    from particle_simulation_tpu_torch.probes import span_cost

    assert span_cost.main(["--device", "cpu", "--small", "--pairs",
                           "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["off_us"] > 0
    for key in ("field_ms_on", "field_ms_off", "mobility_ms_on",
                "mobility_ms_off"):
        assert out[key]["mean"] > 0
    assert profiling._autograd_profiler is torch.autograd.profiler


class _Lib:
    """A kernel library that records the symbols it is called with."""

    def __init__(self):
        self.symbols = []

    def call(self, symbol, *args):
        self.symbols.append(symbol)


def _launch(engine, cfg, monkeypatch):
    """One call of ``engine``'s launch function (``worklog_phase`` or
    ``staged_phase``) on CPU buffers, with the buffer check, the stream
    and the library stood in for: (the function, the library)."""
    from types import SimpleNamespace

    from particle_simulation_tpu_torch.ops.kernels import (
        engine as engines, push_mcc, worklog,
    )
    from particle_simulation_tpu_torch.state import setup_particles

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(engines, "check_buffers", lambda *a: None)
    st = setup_particles(cfg, device="cpu")
    table = torch.zeros((10000, 2), dtype=torch.float32)
    lib = _Lib()
    fn = (worklog.worklog_phase if engine == "worklog"
          else push_mcc.staged_phase)
    fn(lib, st, fn.buffers(st, cfg), table, cfg, 0, cfg.poisson_timestep)
    return fn, lib


@pytest.mark.parametrize("engine", ["worklog", "staged"])
@pytest.mark.parametrize("model", ["reference", "boris", "isotropic",
                                   "periodic", "magnetized_argon"])
def test_general_launch_is_counted_and_spanned(tmp_path, monkeypatch,
                                               engine, model):
    """A launch counts in ``general_launches`` under any model but the
    reference; under a recording profiler it records
    ``pst.mobility.general`` inside ``pst.mobility.launch`` then and only
    then, and with no profiler it records nothing."""
    knobs = {"reference": {}, "boris": dict(integrator="boris"),
             "isotropic": dict(collision_model="isotropic"),
             "periodic": dict(boundary="periodic"),
             "magnetized_argon": dict(
                 integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                 collision_model="isotropic", boundary="periodic",
                 init_vth=2e6)}[model]
    cfg = _config(**knobs)
    general = model != "reference"

    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")

    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        fn, lib = _launch(engine, cfg, monkeypatch)
    assert lib.symbols == [f"pst_{engine}_phase"]
    counts = (fn.launches, fn.general_launches)
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        _launch(engine, cfg, monkeypatch)
    assert (fn.launches, fn.general_launches) == (counts[0] + 1,
                                                  counts[1] + general)
    assert [(n, parent) for n, _, _, parent in _spans(log_dir)
            if n.startswith("pst.mobility")] == (
        [("pst.mobility.launch", None)]
        + [("pst.mobility.general", "pst.mobility.launch")] * general)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card with -m cuda)")
    from particle_simulation_tpu_torch.ops.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
def test_card_run_holds_every_span(tmp_path, card, scheduler):
    """On the card a traced run seeds the state in one launch
    (``pst.setup`` holds ``pst.setup.launch`` alone), runs the subgrid
    field phase as the kernel chain (``pst.field.window``,
    ``.window_readback``, ``.deposit``, ``.gather``: one readback a phase),
    adds the engine's buffers, launch and readback inside ``pst.mobility``
    and the synchronise after each step, and gives the CPU's results."""
    cfg = _config(scheduler)
    on, spans = _traced_run(tmp_path, cfg, card)
    assert {n for n, *_ in spans} == (set(PARENT) - PLAIN_SETUP
                                      - NOT_ON_CARD_SUBGRID)
    for n, _, _, parent in spans:
        assert parent == PARENT[n], (n, parent)
    for n in CARD_ONLY | {"pst.field.window_readback"}:
        assert sum(1 for s in spans if s[0] == n) == cfg.poisson_steps, n
    assert grid_ops.field_counts.paths["subgrid"] == cfg.poisson_steps
    assert grid_ops.field_counts.readbacks == cfg.poisson_steps
    assert [s[0] for s in spans if s[3] == "pst.setup"] == [
        "pst.setup.launch"]
    off = run_pic(cfg, print_header=False, device="cpu")
    assert _counters(on) == _counters(off)
    assert (multiset_with_ids(on.state) == multiset_with_ids(off.state)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
def test_card_general_run_counts_and_spans(tmp_path, card, scheduler):
    """Under magnetized argon every phase on the card launches the general
    instantiation and no other, each launch inside ``pst.mobility.general``
    within ``pst.mobility.launch``, and the run gives the CPU's results."""
    from particle_simulation_tpu_torch.ops.kernels import push_mcc, worklog

    fn = {"dynamic": worklog.worklog_phase,
          "dynamic_old": push_mcc.staged_phase}[scheduler]
    cfg = _config(scheduler, integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                  collision_model="isotropic", boundary="periodic",
                  init_vth=2e6)
    before = (fn.launches, fn.general_launches)
    on, spans = _traced_run(tmp_path, cfg, card)
    steps = cfg.poisson_steps
    assert (fn.launches - before[0], fn.general_launches - before[1]) == (
        steps, steps)
    general = [s for s in spans if s[0] == "pst.mobility.general"]
    assert [s[3] for s in general] == ["pst.mobility.launch"] * steps
    off = run_pic(cfg, print_header=False, device="cpu")
    assert _counters(on) == _counters(off)
    assert (multiset_with_ids(on.state) == multiset_with_ids(off.state)).all()
