"""The benchmark's tests: the harness's own modules and the port on the
path, the card fixture, and a cell cut to a size the CPU runs in
seconds."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# a runPIC row small enough for the plain versions on the CPU: the seed
# cube (62 cells) inside a 64^3 grid, 3 Poisson steps of 8 mobility steps
TINY = dict(init_n=3000, capacity=60000, grid_size=[64, 64, 64],
            poisson_steps=3)
TINY_T = 8


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """tiny(cell_name) -> the benchmark's cell cut to ``TINY``."""
    import harness

    bench = harness.load_benchmark()

    def make(name: str):
        cell = harness.find_cell(bench, name)
        cell.config.update(TINY)
        cell.traffic.update(poisson_timestep=TINY_T)
        return cell

    return make
