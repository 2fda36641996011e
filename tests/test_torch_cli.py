"""The port's CLI (``cli.py``, ``python -m particle_simulation_tpu_torch``)
against the JAX package's: ``parse_args`` field by field on the same argv
lists, errors included; the printed lines of a scheduler mode with the
times masked and its PNGs' pixels; the four scheduler modes agreeing on
the final state through their npz checkpoints; ``bench`` writing the port's
own CSV; and ``test`` as a subprocess.  What only the port has: the
``platform=`` device, ``mesh=`` refused, ``bucket=`` without effect, and
the model selections it does not run refused through
``config.check_supported``."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import particle_simulation_tpu_torch
from particle_simulation_tpu import cli as jcli
from particle_simulation_tpu_torch import checkpoint, cli
from particle_simulation_tpu_torch.cross_section import bundled_paths
from particle_simulation_tpu_torch.observability import read_png
from particle_simulation_tpu_torch.runtime import multiset_with_ids

from test_torch_runtime import masked, printed

REPO = os.path.dirname(os.path.dirname(particle_simulation_tpu_torch.__file__))
CONST = bundled_paths()[1]
RUN = ["0", "150", "2", "256", "20000", "0", "6", "grid=32", f"cs={CONST}"]

ARGVS = {
    "positional": ["30", "2", "1000", "7", "128", "5000", "100", "9",
                   "grid=16"],
    "overrides": ["31", "0", "10", "1", "256", "100", "0", "3", "cs=x.txt",
                  "seed=3", "gridmode=slab", "field=neighbour",
                  "bfield=0,0,0", "precision=f32", "ckpt=some/dir",
                  "platform=cpu", "mesh=0", "bucket=0"],
    "knobs": ["33", "0", "1000", "7", "128", "5000", "100", "9",
              "lookup_hits=1", "worklog_start_buckets=4",
              "kernel_sublanes=64", "lookup_mode=staticguard",
              "spawn_depth=1", "bbox_subgrid=0", "mobility_dt=2e-12"],
    "mode only": ["32"],
    "test": ["test", *RUN],
    "bench": ["bench", "profile=quick", "resume=1"],
    "bench default": ["bench"],
}
BAD_ARGVS = {
    "partial positional": ["32", "1", "1000000", "10"],
    "unknown key": ["30", *RUN, "no_such_knob=1"],
    "tuple field": ["30", *RUN, "grid_size=16"],
    "profile": ["bench", "profile=huge"],
    "bfield arity": ["30", *RUN, "bfield=1,2"],
}


def _fields(opts) -> dict:
    return {"mode": opts.mode, "config": dataclasses.asdict(opts.config),
            "ckpt_dir": opts.ckpt_dir, "bench_profile": opts.bench_profile,
            "bench_resume": opts.bench_resume}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_args_matches_jax(name):
    argv = ARGVS[name]
    assert _fields(cli.parse_args(argv)) == _fields(jcli.parse_args(argv))


@pytest.mark.parametrize("name", sorted(BAD_ARGVS))
def test_parse_args_errors_match_jax(name):
    with pytest.raises(SystemExit) as port:
        cli.parse_args(BAD_ARGVS[name])
    with pytest.raises(SystemExit) as ref:
        jcli.parse_args(BAD_ARGVS[name])
    assert str(port.value) == str(ref.value)


def test_port_only_options():
    base = ["30", *RUN]
    assert cli.parse_args(base).device is None
    assert cli.parse_args(base + ["platform=cpu"]).device == "cpu"
    assert cli.parse_args(base + ["platform=cuda"]).device == "cuda"
    assert cli.parse_args(base + ["bucket=1"]).config == \
        cli.parse_args(base).config
    with pytest.raises(SystemExit, match="platform"):
        cli.parse_args(base + ["platform=tpu"])
    with pytest.raises(SystemExit, match="Queue 1 item 7"):
        cli.parse_args(base + ["mesh=4"])
    for unported in ("precision=f64", "field=fft", "bfield=1,0,0",
                     "integrator=boris", "bbox_subgrid=12"):
        with pytest.raises(SystemExit):
            cli.parse_args(base + [unported])


def test_main_without_args_and_unknown_mode():
    code, out = printed(cli.main, [])
    assert code == 2 and "8-argument" in out
    with pytest.raises(SystemExit, match="unknown mode"):
        cli.main(["31x", "platform=cpu"])


def test_scheduler_mode_lines_and_pngs_match_jax(tmp_path, monkeypatch):
    argv = ["32", "1", *RUN[1:], "platform=cpu"]
    for pkg in ("port", "jax"):
        os.makedirs(tmp_path / pkg)
    monkeypatch.chdir(tmp_path / "port")
    code, out = printed(cli.main, argv)
    monkeypatch.chdir(tmp_path / "jax")
    ref_code, ref_out = printed(jcli.main, argv)
    assert code == ref_code == 0
    assert masked(out) == masked(ref_out)
    assert sum(l.startswith("Amount of particles") for l in out.splitlines()) \
        == 3
    pngs = sorted(os.listdir(tmp_path / "port" / "out" / "visualization"))
    assert pngs == ["test_0000.png", "test_0001.png", "test_0002.png"]
    for name in pngs:
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "port" / "out" / "visualization" / name)),
            read_png(str(tmp_path / "jax" / "out" / "visualization" / name)))


def test_scheduler_modes_agree_through_checkpoints(tmp_path, monkeypatch):
    """Modes 30-33 with ckpt= (verbose 0 becomes 1): a checkpoint a step,
    the final one equal across the four modes."""
    monkeypatch.chdir(tmp_path)
    finals = {}
    for mode in ("30", "31", "32", "33"):
        d = str(tmp_path / f"ck{mode}")
        code, out = printed(cli.main, [mode, *RUN, "platform=cpu",
                                       f"ckpt={d}"])
        assert code == 0 and "CPU time of program" in out
        assert sorted(os.listdir(d)) == [f"step_{t:06d}.npz" for t in range(3)]
        state, step = checkpoint.load_npz(os.path.join(d, "step_000002.npz"),
                                          "cpu")
        assert step == 2
        finals[mode] = multiset_with_ids(state)
    for mode in ("31", "32", "33"):
        np.testing.assert_array_equal(finals[mode], finals["30"])


def test_bench_mode_writes_the_ports_csv(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    code, out = printed(cli.main, ["bench", "profile=ci", "platform=cpu"])
    assert code == 0 and "CPU time of program" in out
    lines = open("out/data/mobility_timesteps_nodet_torch.csv").read(
    ).splitlines()
    assert len(lines) == 5 and not os.path.exists(
        "out/data/mobility_timesteps_nodet.csv")


def test_module_runs_the_test_mode(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "particle_simulation_tpu_torch", "test",
         *RUN, "platform=cpu"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert sum(": success (" in l for l in lines) == 4
    assert lines[-1].startswith("CPU time of program: ")
