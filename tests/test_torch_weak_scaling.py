"""The weak-scaling probe (``probes/weak_scaling.py``) over gloo ranks on
the CPU at 1 and 2 ranks: its rows, its collective counts against the
bytes of the charge grid, the ring all-reduce model ``2*S*(d-1)/d``, the
final population against one process holding the global workload, and
the CSV written only where a path is given."""

import os

import pytest

from particle_simulation_tpu_torch.probes import weak_scaling as ws
from particle_simulation_tpu_torch.runtime import run_pic

CFG = ws.SMALL
GRID_BYTES = 4 * 32 ** 3


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    csv = str(tmp_path_factory.mktemp("ws") / "weak.csv")
    return ws.sweep(CFG, max_ranks=2, device="cpu", csv=csv), csv


def test_rows_and_bytes_model(rows):
    rows, _ = rows
    assert [r["ranks"] for r in rows] == [1, 2]
    for r in rows:
        d = r["ranks"]
        assert r["backend"] == "gloo"
        assert r["n_global_init"] == CFG.init_n * d
        assert r["step_ms_mean"] > 0 and r["step_ms_median"] > 0
        # one charge all-reduce a step, of the whole int32 grid
        assert r["comm"]["charge"][:2] == [1.0, GRID_BYTES]
        assert r["charge_bytes_step"] == GRID_BYTES
        assert r["comm"]["charge"][2] > 0  # timed between synchronises
        assert r["ring_allreduce_bytes"] == 2 * GRID_BYTES * (d - 1) / d
        assert "ranks=%d (gloo)" % d in ws.format_row(r)
    assert rows[0]["ring_allreduce_bytes"] == 0
    assert ws.ring_allreduce_bytes(GRID_BYTES, 4) == 1.5 * GRID_BYTES


def test_final_n_equals_one_process(rows):
    rows, _ = rows
    steps = CFG.poisson_steps + ws.TIMED_STEPS
    for r in rows:
        d = r["ranks"]
        one = run_pic(CFG.replace(init_n=d * CFG.init_n,
                                  capacity=d * CFG.capacity,
                                  poisson_steps=steps),
                      print_header=False, device="cpu")
        assert r["final_n"] == one.final_n > 0


def test_csv_only_where_asked(rows, tmp_path, monkeypatch):
    rows, csv = rows
    lines = open(csv).read().splitlines()
    assert lines[0] == ws.CSV_HEADER and len(lines) == 3
    assert lines[2].startswith("2,%d," % (2 * CFG.init_n))
    monkeypatch.chdir(tmp_path)
    ws.main(["--device", "cpu", "--small", "--max-ranks", "1"])
    assert not os.path.exists("out")
