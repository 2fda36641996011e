"""The port's CLI (``cli.py``, ``python -m particle_simulation_tpu_torch``)
against the JAX package's: ``parse_args`` field by field on the same argv
lists, errors included; the printed lines of a scheduler mode with the
times masked and its PNGs' pixels; the four scheduler modes agreeing on
the final state through their npz checkpoints; ``bench`` writing the port's
own CSV; and ``test`` as a subprocess.  What only the port has: the
``platform=`` device, ``mesh=N`` parsed, ``bucket=`` without effect, and
the model values it does not run (unknown names, ``precision=f64`` on the
engines' modes 30 and 33) refused through ``config.check_supported``; the
model menu's knobs run and print what the JAX CLI prints; ``precision=f64``
in mode 31 equal to ``run_pic``."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

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
    # mesh=N parses to N ranks (the run: tests/test_torch_sharded.py)
    assert cli.parse_args(base + ["mesh=4"]).mesh == 4
    assert cli.parse_args(base + ["mesh=4"]).config == \
        cli.parse_args(base).config
    for unported in ("precision=f64", "field=spectral", "bfield=1,0",
                     "integrator=rk4", "bbox_subgrid=12"):
        with pytest.raises(SystemExit):
            cli.parse_args(base + [unported])
    # the model knobs are ported: the JAX package's values parse
    cfg = cli.parse_args(base + [
        "field=fft", "bfield=0,0,-1.76e9", "integrator=boris",
        "collision_model=isotropic", "boundary=periodic",
        "init_vth=2e6"]).config
    assert (cfg.field_model, cfg.b_field, cfg.integrator) == (
        "fft", (0.0, 0.0, -1.76e9), "boris")
    assert (cfg.collision_model, cfg.boundary, cfg.init_vth) == (
        "isotropic", "periodic", 2e6)


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


MODEL_ARGVS = {
    "magnetized argon": ["integrator=boris", "bfield=0,0,-1.76e9",
                         "collision_model=isotropic", "boundary=periodic",
                         "init_vth=2e6"],
    "fft": ["field=fft", "init_vth=1e5"],
}


@pytest.mark.parametrize("name", sorted(MODEL_ARGVS))
def test_model_knobs_run_and_match_jax(tmp_path, monkeypatch, name):
    """Mode 32 with the model knobs on the CPU: exit 0 and the JAX CLI's
    lines (counts exact; the times masked), the argon-like table of the
    magnetized slice written to a file and passed as ``cs=``."""
    argv = ["32", *RUN[:-1], *MODEL_ARGVS[name], "platform=cpu"]
    if name == "magnetized argon":
        from particle_simulation_tpu_torch.cross_section import (
            argon_like_table, write_table,
        )
        table = str(tmp_path / "argon.txt")
        write_table(table, argon_like_table(gas_density=1e23, dt=1e-12))
        argv = ["32", *RUN[:-1], f"cs={table}", *MODEL_ARGVS[name],
                "platform=cpu"]
    monkeypatch.chdir(tmp_path)
    code, out = printed(cli.main, argv)
    ref_code, ref_out = printed(jcli.main, argv)
    assert code == ref_code == 0
    assert masked(out) == masked(ref_out)

    def totals(text):
        return [line for line in text.splitlines() if line.startswith(
            ("Final amount of particles", "Particles added",
             "Particles removed"))]

    assert len(totals(out)) == 3
    for mode in ("30", "33"):  # both engines' plain versions
        code, engine_out = printed(cli.main, [mode, *argv[1:]])
        assert code == 0 and totals(engine_out) == totals(out)


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


def test_precision_f64_mode_31_equals_run_pic(tmp_path, monkeypatch):
    """Mode 31 (``sync``) with ``precision=f64``: exit 0 and the final
    float64 state of ``run_pic`` on the same config, through its npz
    checkpoint; the engines' modes exit with their message, as the JAX
    CLI's engines raise it."""
    from particle_simulation_tpu_torch import SimConfig
    from particle_simulation_tpu_torch.runtime import run_pic

    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "ck")
    code, out = printed(cli.main, ["31", *RUN, "precision=f64",
                                   "platform=cpu", f"ckpt={d}"])
    assert code == 0 and "CPU time of program" in out
    state, step = checkpoint.load_npz(os.path.join(d, "step_000002.npz"),
                                      "cpu", dtype=torch.float64)
    cfg = SimConfig(init_n=150, capacity=20000, poisson_steps=2,
                    poisson_timestep=6, grid_size=(32, 32, 32),
                    cross_section_path=CONST, scheduler="sync",
                    precision="f64")
    ref = run_pic(cfg, print_header=False, device="cpu")
    assert step == 2 and state.pos.dtype == torch.float64
    assert state.n == ref.final_n and ref.steps[-1].added > 0
    np.testing.assert_array_equal(multiset_with_ids(state),
                                  multiset_with_ids(ref.state))
    for mode, engine in (("30", "work-log"), ("33", "staged")):
        with pytest.raises(SystemExit, match=f"the fused {engine} engine is "
                           "f32-only; use scheduler='sync' or 'naive'"):
            cli.main([mode, *RUN, "precision=f64", "platform=cpu"])
