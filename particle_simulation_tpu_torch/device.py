"""The port's default device.

The entry points that make tensors (``runtime.run_pic``,
``state.setup_particles`` and ``zero_state``, ``cross_section.load_table``,
``interop.state_from_numpy`` and ``table_from_numpy``) run on the card
unless the caller names another device.  Without a card they raise: a run
that was meant for the GPU never continues quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device=\"cpu\" to run its plain PyTorch versions on the CPU")
    return torch.device("cuda")
