"""The port's ``utils/profiling.py``: a ``torch.profiler`` Chrome trace
and the timers that wait for the tensors' device (here the CPU's, which
needs no wait)."""

import json
import os

import torch

from particle_simulation_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        torch.arange(128.0).sum()
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        assert json.load(f)["traceEvents"]


def test_device_timer_accumulates():
    with profiling.DeviceTimer() as t:
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.elapsed_s > 0.0
    before = t.elapsed_s
    assert t.stop(x, (x, [x]), {"a": x}, 3) >= before


def test_time_fn_returns_median_seconds():
    calls = []

    def fn(a):
        calls.append(1)
        return {"out": (a * 2.0,)}

    dt = profiling.time_fn(fn, torch.ones(8, 128), iters=3, warmup=1)
    assert dt >= 0.0 and len(calls) == 4
