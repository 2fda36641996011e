"""The port's entry points run on the card unless the caller names another
device, and without a card they raise instead of falling back to the CPU
(particle_simulation_tpu_torch/device.py)."""

import pytest
import torch

from particle_simulation_tpu_torch import SimConfig, cross_section, interop
from particle_simulation_tpu_torch.device import resolve
from particle_simulation_tpu_torch.runtime import run_pic
from particle_simulation_tpu_torch.state import setup_particles, zero_state

CFG = SimConfig(init_n=50, capacity=256, grid_size=(16, 16, 16),
                poisson_timestep=2, poisson_steps=1, scheduler="naive")


def _arrays():
    return interop.state_to_numpy(setup_particles(CFG, device="cpu"))


ENTRY_POINTS = {
    "run_pic": lambda **kw: run_pic(CFG, **kw).state,
    "setup_particles": lambda **kw: setup_particles(CFG, **kw),
    "zero_state": lambda **kw: zero_state(CFG, **kw),
    "load_table": lambda **kw: cross_section.load_table(**kw),
    "state_from_numpy": lambda **kw: interop.state_from_numpy(_arrays(), **kw),
    "table_from_numpy": lambda **kw: interop.table_from_numpy(
        cross_section.generate_table(), **kw),
}


def _device(out):
    return out.device if isinstance(out, torch.Tensor) else out.pos.device


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_a_card_or_an_explicit_device(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = ENTRY_POINTS[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    assert _device(call(device="cpu")).type == "cpu"


def test_resolve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve() == torch.device("cuda")
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("meta")) == torch.device("meta")
