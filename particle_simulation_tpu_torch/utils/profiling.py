"""Profiling / tracing (counterpart of
``particle_simulation_tpu/utils/profiling.py``).

Reference equivalents (SURVEY.md §5.1): the nsys wrapper (`report:1`), CUDA
events around the sim loop (src/pic.cu:374-376, 570-572) and the chrono
process timer (src/main.cu:19,45).  Here: a ``torch.profiler`` trace
exported for chrome://tracing or Perfetto, and host-clock timers that
synchronise the devices of the tensors they are given.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str = "out/trace"):
    """Profile the body (the CPU, and the card when there is one) and write
    a Chrome trace into ``log_dir``: ``with profiling.trace(): run_pic(cfg)``.
    Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


def block_until_ready(*outputs) -> None:
    """Wait for every CUDA device that holds a tensor in ``outputs``
    (tensors, or tuples, lists and dicts of them, nested)."""
    devices = set()
    stack = list(outputs)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class DeviceTimer:
    """Host-clock timer that waits for the device, the CUDA-events
    equivalent of the reference."""

    def __init__(self):
        self.t0 = None
        self.elapsed_s = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s += time.perf_counter() - self.t0
        return False

    def stop(self, *tensors):
        block_until_ready(tensors)
        self.elapsed_s += time.perf_counter() - self.t0
        return self.elapsed_s


def time_fn(fn, *args, iters: int = 3, warmup: int = 1):
    """Median wall time (s) of fn(*args), each call waited for."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
