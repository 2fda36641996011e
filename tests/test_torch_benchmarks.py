"""The port's benchmark sweep (``benchmarks.py``) against the JAX
package's: the three profiles field by field, the ``ci`` sweep's CSV with
the time column masked (tolerance: exact), and the sweep's bookkeeping as
tests/test_benchmarks.py checks it: resume, ``repeat_map``, the filters and
the ``.bak`` rename.  The default CSV is not the tracked TPU artifact."""

import dataclasses
import os

import pytest

from particle_simulation_tpu import benchmarks as jbench
from particle_simulation_tpu_torch import benchmarks
from particle_simulation_tpu_torch.observability import CSV_HEADER


def _rows(path):
    """The CSV's lines with the time column masked."""
    lines = open(path).read().strip().split("\n")
    return lines[:1] + [",".join(l.split(",")[:8] + ["<t>"])
                        for l in lines[1:]]


def _key(line):
    return line.split(",")[0], line.split(",")[3]  # (func, T)


@pytest.mark.parametrize("profile", ["ci", "quick", "full"])
def test_sweep_configs_match_jax(profile):
    port = [dataclasses.asdict(c) for c in benchmarks.sweep_configs(profile)]
    ref = [dataclasses.asdict(c) for c in jbench.sweep_configs(profile)]
    assert port == ref


def test_ci_sweep_csv_matches_jax(tmp_path):
    out, ref = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    runs = benchmarks.run_benchmark("ci", out_csv=out, device="cpu")
    jbench.run_benchmark("ci", out_csv=ref,
                         hints_path=str(tmp_path / "hints.json"),
                         poison_path=str(tmp_path / "poison.json"))
    assert _rows(out) == _rows(ref)
    assert _rows(out)[0] == CSV_HEADER and len(runs) == 4
    assert all(benchmarks.estimate_pushes(r) > 0 for r in runs)
    assert all(r.state is None for r in runs)
    times = [float(l.split(",")[8]) for l in open(out).read().split("\n")[1:]
             if l]
    assert times == [r.device_time_ms for r in runs]


def test_sweep_resume_fills_only_missing_rows(tmp_path):
    out = str(tmp_path / "sweep.csv")
    benchmarks.run_benchmark("ci", out_csv=out, device="cpu")
    lines_full = open(out).read().strip().split("\n")

    # resume over a complete CSV records nothing
    assert benchmarks.run_benchmark("ci", out_csv=out, resume=True,
                                    device="cpu") == []
    assert open(out).read().strip().split("\n") == lines_full

    # a crash: drop the tail half; the resume fills exactly it
    cut = 1 + (len(lines_full) - 1) // 2
    with open(out, "w") as f:
        f.write("\n".join(lines_full[:cut]) + "\n")
    refilled = benchmarks.run_benchmark("ci", out_csv=out, resume=True,
                                        device="cpu")
    assert len(refilled) == len(lines_full) - cut
    lines_now = open(out).read().strip().split("\n")
    assert sorted(map(_key, lines_now[1:])) == sorted(map(_key, lines_full[1:]))

    # repeat_map tops up to the requested rep count
    benchmarks.run_benchmark("ci", out_csv=out, resume=True,
                             repeat_map={("naive", 4): 3}, device="cpu")
    naive4 = [l for l in open(out).read().strip().split("\n")[1:]
              if _key(l) == ("Naive", "4")]
    assert len(naive4) == 3 and len(set(l.split(",")[7] for l in naive4)) == 1


def test_filters_and_fresh_start(tmp_path):
    out = str(tmp_path / "sweep.csv")
    with open(out, "w") as f:
        f.write("an earlier sweep\n")
    runs = benchmarks.run_benchmark("ci", out_csv=out, device="cpu",
                                    only_schedulers=["sync"],
                                    max_t={"sync": 4})
    assert [(r.config.scheduler, r.config.poisson_timestep) for r in runs] \
        == [("sync", 4)]
    assert open(out + ".bak").read() == "an earlier sweep\n"
    assert [_key(l) for l in _rows(out)[1:]] == [("CPU Sync", "4")]
    assert benchmarks.run_benchmark("ci", out_csv=str(tmp_path / "b.csv"),
                                    device="cpu", time_budget_s=1e-9) == []


def test_default_csv_is_not_the_tpu_artifact():
    assert benchmarks.DEFAULT_CSV != jbench._DEFAULT_CSV
    assert os.path.basename(benchmarks.DEFAULT_CSV).endswith("_torch.csv")
