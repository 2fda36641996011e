"""The benchmark's frozen inputs against the port that generates and runs
them: each configuration builds a ``SimConfig`` the port supports, and the
magnetized-argon table is the port's argon-like table bit for bit.

The harness (``benchmark/harness.py``) is imported from its folder, as
the benchmark's own tests do."""

import os
import sys

import numpy as np
import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.config import check_supported
from particle_simulation_tpu_torch.cross_section import argon_like_table
from particle_simulation_tpu_torch.ops.kernels.engine import model_bits

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")


@pytest.fixture
def harness(monkeypatch):
    monkeypatch.syspath_prepend(BENCH_DIR)
    import harness

    return harness


def _cells(harness):
    bench = harness.load_benchmark()
    return {w["name"]: harness.find_cell(bench, w["name"])
            for w in bench["workloads"]}


def test_argon_table_is_the_ports(harness):
    """``tables/argon_like_1e23.txt``, parsed as the harness parses it,
    equals ``argon_like_table(gas_density=1e23, dt=1e-12)`` bit for bit."""
    cell = _cells(harness)["magargon512.t100.dynamic"]
    assert cell.config["table"] == "tables/argon_like_1e23.txt"
    frozen = harness.load_table(cell, "cpu")
    want = torch.from_numpy(argon_like_table(gas_density=1e23, dt=1e-12))
    assert frozen.dtype == want.dtype == torch.float32
    assert torch.equal(frozen.view(torch.int32), want.view(torch.int32))
    assert float(frozen[:, 0].max()) > 0, "no ionisation in the table"


@pytest.mark.parametrize("name, general", [
    ("sine512.t100.dynamic", False), ("const512.t100.dynamic", False),
    ("sine512.t10.dynamic", False), ("sine512.t100.dynamic_old", False),
    ("magargon512.t100.dynamic", True)])
def test_cell_is_a_supported_config(harness, name, general):
    """Every cell's keys build a ``SimConfig`` the port supports; only the
    magnetized-argon cell runs the engines' general instantiation."""
    cell = _cells(harness)[name]
    cfg = SimConfig(**harness.run_keys(cell), seed=2**31 + 977)
    check_supported(cfg)
    assert (model_bits(cfg) != 0) == general
    assert bool(cfg.init_vth) == general
    assert np.isfinite(cfg.sim_size).all()
