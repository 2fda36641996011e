"""The plain reference against the port's CPU path, and the comparison
against the control and the faults, at a size the CPU runs in seconds."""

import time

import pytest
import torch

import faults
import harness
import judge

CELLS = ["sine512.t100.dynamic", "const512.t100.dynamic",
         "sine512.t100.dynamic_old"]
SEED = 2**31 + 977


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_port(tiny, name):
    """The same counters every step and the same final multiset, ids and
    bit patterns included, from one seed."""
    cell = tiny(name)
    table = harness.load_table(cell, "cpu")
    port = harness.PortProgram("cpu")
    counters, rows = port.episode(
        port.config(harness.run_keys(cell), SEED), table)
    ref = harness.reference_module(cell).episode(
        {**cell.config, **cell.traffic}, SEED, table)
    assert counters == ref.counters
    assert torch.equal(judge.sort_rows(rows), judge.sort_rows(ref.rows))
    if name.startswith("const"):  # the sine table splits at higher energies
        assert sum(c[1] for c in counters) > 0, "no split"


@pytest.mark.parametrize("traced", [False, True])
def test_run_is_correct(tiny, traced):
    cell = tiny("sine512.t100.dynamic")
    r = harness.run_cell(cell, SEED, 0.5, traced, "cpu", time.perf_counter())
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "compared"
    want = cell.per_layer if traced else cell.end_to_end
    # device metrics have nothing to read on the CPU
    got = set(r["metrics"])
    assert got <= {m["name"] for m in want}
    assert ("field_ms" in got) if traced else ("pushes_per_s" in got)


@pytest.mark.parametrize("name", ["sine512.t100.dynamic",
                                  "const512.t100.dynamic"])
def test_control_is_rejected(tiny, name):
    """The reference in bfloat16 in the program's place fails."""
    cell = tiny(name)
    r = harness.run_cell(cell, SEED, 0.1, False, "cpu", time.perf_counter(),
                         program=harness.ReferenceProgram(cell,
                                                          torch.bfloat16))
    assert not r["correct"]
    assert r["compared"]["rows_off"]["value"] > 0


# the traced path calls the Poisson step's two calls, not run_pic
@pytest.mark.parametrize("fault, traced", [
    (f, t) for f in sorted(faults.FAULTS) for t in (False, True)
    if not (t and f == "altered")])
def test_fault_is_rejected(tiny, fault, traced):
    """A run with the timed path broken underneath reads correct false."""
    cell = tiny("const512.t100.dynamic")
    with faults.FAULTS[fault]():
        r = harness.run_cell(cell, SEED, 0.1, traced, "cpu",
                             time.perf_counter(),
                             program=harness.PortProgram("cpu"))
    assert not r["correct"], r["compared"]


def test_each_episode_is_held_to_its_own_seed(tiny):
    """A run's simulation seeds are distinct and fixed by its seed, change
    the work, and each episode is judged against its own seed's
    reference."""
    cell = tiny("const512.t100.dynamic")
    seeds = harness.episode_seeds(cell, SEED)
    assert len(set(seeds)) == len(seeds) == 4
    assert seeds == harness.episode_seeds(cell, SEED)
    assert seeds != harness.episode_seeds(cell, SEED + 1)
    table = harness.load_table(cell, "cpu")
    port = harness.PortProgram("cpu")
    keys = harness.run_keys(cell)
    runs = [port.episode(port.config(keys, s), table) for s in seeds[:2]]
    assert runs[0][0] != runs[1][0], "two seeds, one population"
    refs = [harness.reference_module(cell).episode(
        {**cell.config, **cell.traffic}, s, table) for s in seeds[:2]]
    counters = [c for c, _ in runs] * 2
    prints = [judge.fingerprint(rows) for _, rows in runs] * 2
    numbers = judge.compare(counters, prints, 0, (3, runs[1][1]), refs)
    assert judge.verdict(numbers), numbers
    swapped = judge.compare(counters, prints, 0, (3, runs[1][1]), refs[::-1])
    assert swapped["episodes_counters_off"] == 4
    assert swapped["episodes_multiset_off"] == 4
    assert swapped["rows_off"] > 0


def test_judge_counts_rows():
    a = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    b = a.flip(0).clone()
    assert judge.rows_off(a, b) == 0
    assert torch.equal(judge.fingerprint(a), judge.fingerprint(b))
    b[1, 2] += 1
    assert judge.rows_off(a, b) == 1
    assert not torch.equal(judge.fingerprint(a), judge.fingerprint(b))
    assert judge.rows_off(a, a[:2]) == 2


@pytest.mark.cuda
def test_card_run_is_correct(card, tiny):
    """The kernels' path on the card, untraced and traced, against the
    reference; the roofline share within 100%."""
    for name in CELLS:
        cell = tiny(name)
        for traced in (False, True):
            r = harness.run_cell(cell, SEED, 0.5, traced, card,
                                 time.perf_counter())
            assert r["correct"], (name, traced, r["compared"])
            if traced:
                m = r["metrics"]
                assert 0 < m["mobility_roofline"]["value"] <= 100
                assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
