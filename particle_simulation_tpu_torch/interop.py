"""State and weights carried between the JAX package and the port, through
numpy.

A JAX ``SimState`` as numpy arrays is the dict of ``checkpoint._FIELDS``
(pos, vel, acc, status, id_hi, id_lo, n), which is also what the JAX
package's npz checkpoints hold.  The ids are uint32 there and int32 bit
patterns in the port.  The cross-section table, a (10000, 2) float32 array,
is the only weight this system has.
"""

from __future__ import annotations

import numpy as np
import torch

from .cross_section import N_STEPS
from .device import resolve
from .state import SimState

FIELDS = ("pos", "vel", "acc", "status", "id_hi", "id_lo", "n")


def state_from_numpy(arrays: dict, device=None) -> SimState:
    """A JAX SimState given as numpy arrays -> the port's state on
    ``device`` (the card when None, device.resolve)."""
    device = resolve(device)

    def t(name, dtype):
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        return torch.from_numpy(a.view(dtype).copy()).to(device)

    return SimState(
        pos=t("pos", np.float32), vel=t("vel", np.float32),
        acc=t("acc", np.float32), status=t("status", np.int32),
        id_hi=t("id_hi", np.int32), id_lo=t("id_lo", np.int32),
        n=int(np.asarray(arrays["n"])),
    )


def state_to_numpy(state: SimState) -> dict:
    """The port's state -> numpy arrays in the JAX SimState's types."""

    def a(x):
        return x.detach().cpu().numpy()

    return {
        "pos": a(state.pos), "vel": a(state.vel), "acc": a(state.acc),
        "status": a(state.status),
        "id_hi": a(state.id_hi).view(np.uint32),
        "id_lo": a(state.id_lo).view(np.uint32),
        "n": np.int32(state.n),
    }


def table_from_numpy(table, device=None) -> torch.Tensor:
    """A (10000, 2) float32 cross-section table -> tensor on ``device``
    (the card when None, device.resolve)."""
    device = resolve(device)
    a = np.ascontiguousarray(np.asarray(table, dtype=np.float32))
    if a.shape != (N_STEPS, 2):
        raise ValueError(f"table has shape {a.shape}, expected ({N_STEPS}, 2)")
    return torch.from_numpy(a.copy()).to(device)
