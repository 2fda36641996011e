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
       for p in ("zero", "ids", "pos", "vel", "select")},
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
# what each field path leaves out of the field phase's spans
NOT_ON_PATH = {"subgrid": set(), "window_fallback": set(),
               "full": {"pst.field.window", "pst.field.window_readback"}}
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
    want = set(PARENT) - CARD_ONLY - NOT_ON_PATH[path] - {"pst.setup.vel"}
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
    """On the card a traced run adds the engine's buffers, launch and
    readback inside ``pst.mobility`` and the synchronise after each step,
    and gives the CPU's results."""
    cfg = _config(scheduler)
    on, spans = _traced_run(tmp_path, cfg, card)
    assert {n for n, *_ in spans} == set(PARENT) - {"pst.setup.vel"}
    for n, _, _, parent in spans:
        assert parent == PARENT[n], (n, parent)
    for n in CARD_ONLY:
        assert sum(1 for s in spans if s[0] == n) == cfg.poisson_steps, n
    off = run_pic(cfg, print_header=False, device="cpu")
    assert _counters(on) == _counters(off)
    assert (multiset_with_ids(on.state) == multiset_with_ids(off.state)).all()
