"""The port imports neither jax nor the JAX package, at import time or
anywhere in its sources (the test process itself has jax loaded through
conftest.py, so the import check runs in a fresh interpreter), no source
names the JAX package's C extension, and every module imports without
pandas, matplotlib or PIL."""

import os
import re
import subprocess
import sys

import particle_simulation_tpu_torch

PKG = os.path.dirname(particle_simulation_tpu_torch.__file__)
REPO = os.path.dirname(PKG)
MODULES = [
    "particle_simulation_tpu_torch",
    "particle_simulation_tpu_torch.benchmarks",
    "particle_simulation_tpu_torch.checkpoint",
    "particle_simulation_tpu_torch.cli",
    "particle_simulation_tpu_torch.config",
    "particle_simulation_tpu_torch.constants",
    "particle_simulation_tpu_torch.cross_section",
    "particle_simulation_tpu_torch.device",
    "particle_simulation_tpu_torch.fma",
    "particle_simulation_tpu_torch.interop",
    "particle_simulation_tpu_torch.models",
    "particle_simulation_tpu_torch.models.poisson_fft",
    "particle_simulation_tpu_torch.observability",
    "particle_simulation_tpu_torch.rng",
    "particle_simulation_tpu_torch.runtime",
    "particle_simulation_tpu_torch.schedulers",
    "particle_simulation_tpu_torch.state",
    "particle_simulation_tpu_torch.testing",
    "particle_simulation_tpu_torch.utils",
    "particle_simulation_tpu_torch.utils.buildlib",
    "particle_simulation_tpu_torch.utils.fastio",
    "particle_simulation_tpu_torch.utils.profiling",
    "particle_simulation_tpu_torch.ops.grid",
    "particle_simulation_tpu_torch.ops.physics",
    "particle_simulation_tpu_torch.ops.population",
    "particle_simulation_tpu_torch.ops.step",
    "particle_simulation_tpu_torch.ops.kernels.build",
    "particle_simulation_tpu_torch.ops.kernels.compact",
    "particle_simulation_tpu_torch.ops.kernels.field",
    "particle_simulation_tpu_torch.ops.kernels.lookup_bench",
    "particle_simulation_tpu_torch.ops.kernels.push_mcc",
    "particle_simulation_tpu_torch.ops.kernels.sublane_gather",
    "particle_simulation_tpu_torch.ops.kernels.worklog",
    "particle_simulation_tpu_torch.parallel",
    "particle_simulation_tpu_torch.parallel.launch",
    "particle_simulation_tpu_torch.parallel.sharded",
    "particle_simulation_tpu_torch.probes",
    "particle_simulation_tpu_torch.probes.common",
    "particle_simulation_tpu_torch.probes.experiment_sublane_gather",
    "particle_simulation_tpu_torch.probes.experiment_worklog",
    "particle_simulation_tpu_torch.probes.gloo_cuda",
    "particle_simulation_tpu_torch.probes.microbench_fieldgather",
    "particle_simulation_tpu_torch.probes.microbench_lookup",
    "particle_simulation_tpu_torch.probes.probe_times",
    "particle_simulation_tpu_torch.probes.span_cost",
    "particle_simulation_tpu_torch.probes.ptxas",
    "particle_simulation_tpu_torch.probes.step_times",
    "particle_simulation_tpu_torch.probes.sweep_sensitivity",
    "particle_simulation_tpu_torch.probes.worklog_phase",
    "particle_simulation_tpu_torch.probes.weak_scaling",
]
ANALYSE = [
    f"particle_simulation_tpu_torch.analyse.{m}" for m in (
        "common", "plot_all", "plot_cc", "plot_init_n", "plot_mobility",
        "plot_particles_added", "plot_poisson_steps", "plot_tile",
        "plot_validation", "to_gif", "analyse_random")
]
MODULES += ["particle_simulation_tpu_torch.analyse", *ANALYSE]


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'particle_simulation_tpu' or "
        "m.startswith('particle_simulation_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr


def test_import_without_pandas_or_matplotlib():
    """Every module imports where pandas, matplotlib and PIL are missing,
    as on the card's machine (the analysis scripts import them inside
    their functions)."""
    code = (
        "import importlib, sys\n"
        "for m in ('pandas', 'matplotlib', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|particle_simulation_tpu)(\.|\s|$)", re.M)
    py = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
          if f.endswith(".py")]
    py.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(py) >= len(MODULES)
    for path in py:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_sources_name_no_jax_extension():
    """The port builds its own IO library (csrc/fastio.c): no source of it
    reads the JAX package's C extension or its source folder."""
    pattern = re.compile(r"native/|\b_fastio\b")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith((".py", ".c", ".cu", ".cuh"))]
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    assert any(p.endswith("fastio.c") for p in paths)
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path
