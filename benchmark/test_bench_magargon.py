"""The magnetized-argon cell: its plain reference against the port's CPU
path, the comparison against the control and a fault, and the frozen
operation count of its roofline, at a size the CPU runs in seconds."""

import time
import types

import pytest
import torch

import bound_general
import devtrace
import faults
import harness
import judge

CELL = "magargon512.t100.dynamic"
SEED = 2**31 + 977
# the cell at TINY; a box of 16 cells, a step of 1e-9 s at 1e6 m/s (0.1
# cell a step), so lanes wrap; a field strong enough to move every
# velocity's bits
CASES = {
    "tiny": {},
    "wrap": dict(grid_size=[16, 16, 16], mobility_dt=1e-9, init_vth=1e6),
    "strong_field": dict(b_field=[3e11, -5e11, 7e11]),
}


def _cell(tiny, case, scheduler="dynamic"):
    cell = tiny(CELL)
    cell.config.update(CASES[case])
    cell.traffic.update(scheduler=scheduler)
    return cell


def _port(cell):
    table = harness.load_table(cell, "cpu")
    port = harness.PortProgram("cpu")
    return port.episode(port.config(harness.run_keys(cell), SEED), table)


def _reference(cell):
    table = harness.load_table(cell, "cpu")
    return harness.reference_module(cell).episode(
        {**cell.config, **cell.traffic}, SEED, table)


def _by_id(rows):
    """Rows in the order of their ids (id_hi, id_lo)."""
    key = (rows[:, 10].to(torch.int64) << 32) | (rows[:, 11].to(torch.int64)
                                                  & 0xFFFFFFFF)
    return rows[torch.argsort(key)]


@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_port(tiny, case, scheduler, monkeypatch):
    """The same counters every step and the same final multiset, ids and
    bit patterns included, from one seed; children are made, and the wrap
    case wraps."""
    cell = _cell(tiny, case, scheduler)
    counters, rows = _port(cell)
    ref_module = harness.reference_module(cell)
    wrapped = []
    real_wrap = ref_module.wrap

    def wrap(pos, size):
        out = real_wrap(pos, size)
        wrapped.append(int((out != pos).any(dim=1).sum()))
        return out

    monkeypatch.setattr(ref_module, "wrap", wrap)
    ref = _reference(cell)
    assert counters == ref.counters
    assert torch.equal(judge.sort_rows(rows), judge.sort_rows(ref.rows))
    assert sum(c[1] for c in counters) > 0, "no isotropic child"
    assert (sum(wrapped) > 0) == (case == "wrap")


def test_strong_field_moves_every_velocity(tiny):
    """The strong field's run and the cell's share their ids here, and
    each component of a final velocity differs between them but in the
    few children of the last steps that never moved, whose speed rounds
    alike."""
    weak, strong = (_reference(_cell(tiny, c)) for c in ("tiny",
                                                         "strong_field"))
    a, b = _by_id(weak.rows), _by_id(strong.rows)
    assert torch.equal(a[:, 10:], b[:, 10:])
    alike = (a[:, 3:6] == b[:, 3:6]).any(dim=1)
    assert int(alike.sum()) <= 0.01 * a.shape[0]


def test_reference_refuses_another_model(tiny):
    cell = _cell(tiny, "tiny")
    table = harness.load_table(cell, "cpu")
    ref = harness.reference_module(cell)
    keys = {**cell.config, **cell.traffic}
    for change in (dict(integrator="leapfrog"),
                   dict(collision_model="reverse"), dict(boundary="absorb"),
                   dict(field_model="fft"), dict(b_field=[0.0, 0.0, 0.0]),
                   dict(init_vth=0.0), dict(grid_size=[64, 64, 32])):
        with pytest.raises(ValueError):
            ref.episode({**keys, **change}, SEED, table)


def test_run_is_correct(tiny):
    cell = _cell(tiny, "tiny")
    r = harness.run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_control_is_rejected(tiny):
    """The reference in bfloat16 in the program's place fails."""
    cell = _cell(tiny, "tiny")
    r = harness.run_cell(cell, SEED, 0.1, False, "cpu", time.perf_counter(),
                         program=harness.ReferenceProgram(cell,
                                                          torch.bfloat16))
    assert not r["correct"]
    assert r["compared"]["rows_off"]["value"] > 0


def test_bit_flip_is_rejected(tiny):
    """One bit of one velocity flipped in the final state fails."""
    cell = _cell(tiny, "tiny")
    with faults.FAULTS["altered"]():
        r = harness.run_cell(cell, SEED, 0.1, False, "cpu",
                             time.perf_counter(),
                             program=harness.PortProgram("cpu"))
    assert not r["correct"], r["compared"]


def test_bound_counts_the_model():
    """121 operations a push at 13 rounds under block2 (the main path's
    70, the rotation's 36, the wrap's 15) and 22 a child; the children
    counted from the rows' growth alone."""
    assert bound_general.ops_per_push(13, True) == 121
    ops = lambda pushes, n_in, n_out: (  # noqa: E731
        bound_general.phase_bound_s(pushes, n_in, n_out, 13, True)
        * bound_general.bound.F32_OPS_PER_S)
    assert ops(10**9, 10**6, 10**6 + 1000) == pytest.approx(
        121 * 10**9 + 22 * 1000)
    assert ops(10**9, 10**6, 10**6 - 1000) == pytest.approx(121 * 10**9)


def test_metrics_read_the_general_kernels():
    """On a synthetic trace of two phases: ``general_engine_ms`` sums the
    kernels whose GENERAL argument is true over the general spans, and
    ``general_roofline`` the bound over the device time in the mobility
    spans; without the span (a program that lacks it) or a trace, None."""
    kernel = "void pst::worklog_phase<2, 13, true, {}>(pst::PhaseArgs)"
    host = sorted([(0.0, 1000.0, "bench.window"),
                   (100.0, 400.0, "bench.mobility"),
                   (110.0, 120.0, "pst.mobility.launch"),
                   (111.0, 119.0, "pst.mobility.general"),
                   (500.0, 900.0, "bench.mobility"),
                   (510.0, 520.0, "pst.mobility.launch"),
                   (511.0, 519.0, "pst.mobility.general")],
                  key=lambda h: (h[0], -h[1]))
    device = [(kernel.format("true"), 115.0, 315.0),
              (kernel.format("true"), 515.0, 815.0),
              (kernel.format("false"), 320.0, 330.0),
              ("void at::native::fill", 340.0, 350.0)]
    spans = {"bench.mobility": [(100.0, 400.0), (500.0, 900.0)]}
    trace = devtrace.Trace((0.0, 1000.0), device, spans, host)
    cell = harness.find_cell(harness.load_benchmark(), CELL)
    phases = [(10**6, 1000, 1500), (2 * 10**6, 1500, 1400)]
    r = types.SimpleNamespace(trace=trace, cell=cell, phases=phases)
    assert harness.reader("general_engine_ms")(r) == pytest.approx(
        500e-3 / 2)
    least = sum(bound_general.phase_bound_s(p, a, b, 13, True)
                for p, a, b in phases)
    assert harness.reader("general_roofline")(r) == pytest.approx(
        least / 520e-6 * 100)
    trace.host = [h for h in host if h[2] != "pst.mobility.general"]
    assert harness.reader("general_engine_ms")(r) is None
    r.trace = None
    assert harness.reader("general_engine_ms")(r) is None
    assert harness.reader("general_roofline")(r) is None


@pytest.mark.cuda
def test_card_run_is_correct(card, tiny):
    """The general instantiation on the card against the reference,
    untraced and traced: every phase launches it and no other, and the
    cell's metrics read within range."""
    from particle_simulation_tpu_torch.ops.kernels.worklog import (
        worklog_phase,
    )

    for traced in (False, True):
        cell = _cell(tiny, "tiny")
        before = (worklog_phase.launches, worklog_phase.general_launches)
        r = harness.run_cell(cell, SEED, 0.5, traced, card,
                             time.perf_counter())
        assert r["correct"], (traced, r["compared"])
        launches = worklog_phase.launches - before[0]
        assert worklog_phase.general_launches - before[1] == launches > 0
        if traced:
            m = r["metrics"]
            assert 0 < m["general_roofline"]["value"] <= 100
            assert m["general_engine_ms"]["value"] > 0
