"""The port's ``utils/profiling.py``: a ``torch.profiler`` Chrome trace
(its spans: tests/test_torch_tracing.py)."""

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
