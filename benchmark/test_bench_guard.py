"""What a run refuses: JAX or the JAX package in its process (top-level
names compared whole), a machine without the card, a checkout without
the program; and the trace's arithmetic."""

import json
import os
import shutil
import subprocess
import sys
import types

import devtrace
import harness

RUN = os.path.join(harness.BENCH_DIR, "run.py")


def test_forbidden_names_compare_whole(monkeypatch):
    assert harness.forbidden_modules() == []
    for name in ("particle_simulation_tpu_torch.x", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "particle_simulation_tpu.ops",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "particle_simulation_tpu"]


def test_a_run_loads_no_jax():
    """A whole run in a fresh interpreter (the CPU path, a tiny cell)
    leaves neither JAX nor the JAX package in ``sys.modules``."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "cell = harness.find_cell(harness.load_benchmark(), "
        "'sine512.t100.dynamic')\n"
        "cell.config.update(init_n=500, capacity=5000, grid_size=[64]*3, "
        "poisson_steps=1)\n"
        "cell.traffic.update(poisson_timestep=4)\n"
        "r = harness.run_cell(cell, 7, 0.1, True, 'cpu', time.perf_counter(),"
        " log=sys.stderr)\n"
        "print(r['correct'], harness.forbidden_modules())\n"
    ) % (harness.BENCH_DIR, harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "True []"


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sine512.t10.dynamic", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{\"correct\"")


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(harness.ROOT, env)
    assert out.returncode != 0 and _no_result(out)


def test_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)
    assert "particle_simulation_tpu_torch" in out.stderr


def test_trace_arithmetic(tmp_path):
    """Busy and idle time, kernels inside a span and the idle labels of a
    small synthetic trace."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "pid": 1, "tid": 1, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.mobility",
         "pid": 1, "tid": 1, "ts": 10, "dur": 40},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "pid": 1,
         "tid": 1, "ts": 55, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "pid": 0, "tid": 7,
         "ts": 20, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "pid": 0, "tid": 7,
         "ts": 30, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "pid": 0, "tid": 7,
         "ts": 90, "dur": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = devtrace.read(str(path))
    assert t.busy() == [(20.0, 50.0), (90.0, 95.0)]
    assert abs(t.busy_s() - 35e-6) < 1e-12
    assert abs(t.device_s_in("bench.mobility") - 40e-6) < 1e-12
    assert t.top_device_ops()[0][0] == "k2"
    idle = dict(t.top_idle())
    assert abs(idle["bench.window/aten::item"] - 40e-6) < 1e-12
    assert abs(idle["bench.mobility"] - 20e-6) < 1e-12
    assert abs(sum(idle.values()) - 65e-6) < 1e-12
