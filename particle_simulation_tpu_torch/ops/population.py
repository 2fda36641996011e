"""Dynamic population under a fixed capacity: child append and dead-slot
compaction (counterpart of ``particle_simulation_tpu/ops/population.py``).

Semantics of the reference kept: children land in slots [n, n+k) in source
order; children beyond capacity are dropped but still counted in ``n`` so
overflow is visible (src/pic.cu:127-131, 543-545); compaction closes ranks
in order and resets survivors to ALIVE (src/pic.cu:320-357).
"""

from __future__ import annotations

import torch

from ..constants import STATUS_ALIVE, STATUS_EMPTY
from ..state import SimState
from .physics import Particles


def is_live(status: torch.Tensor) -> torch.Tensor:
    """Slots holding a live particle (alive-from-start or spawned)."""
    return (status == STATUS_ALIVE) | (status > 0)


def append_children(state: SimState, spawn: torch.Tensor,
                    child: Particles) -> SimState:
    """Place the children marked by ``spawn`` at slots [n, n+k) in source
    order (``spawn`` and ``child`` may cover any prefix of the slots).

    Writes into the state's tensors in place (the caller owns them) and
    returns the state with the new ``n``."""
    src = torch.nonzero(spawn).flatten()
    k = src.numel()
    keep = max(0, min(k, state.capacity - state.n))
    if keep:
        src = src[:keep]
        dst = slice(state.n, state.n + keep)
        state.pos[dst] = torch.stack([child.px[src], child.py[src],
                                      child.pz[src]], 1)
        state.vel[dst] = torch.stack([child.vx[src], child.vy[src],
                                      child.vz[src]], 1)
        state.acc[dst] = torch.stack([child.ax[src], child.ay[src],
                                      child.az[src]], 1)
        state.status[dst] = child.status[src]
        state.id_hi[dst] = child.id_hi[src]
        state.id_lo[dst] = child.id_lo[src]
    return state._replace(n=state.n + k)


def reclaim(state: SimState):
    """Mid-phase dead-slot reclamation: drop the rows below ``n`` that hold
    no live particle, close ranks (stable) and keep every surviving status
    as it is.  Returns (state, reclaimed row count); callers add the count
    back into added/removed, as the JAX package's ``reclaim`` callers do.
    Physics does not change: draws are keyed by genealogy, not slot."""
    m = state.n_clamped
    src = torch.nonzero(is_live(state.status[:m])).flatten()
    n_new = src.numel()

    def take(a):
        out = torch.zeros_like(a)
        out[:n_new] = a[src]
        return out

    return SimState(
        take(state.pos), take(state.vel), take(state.acc), take(state.status),
        take(state.id_hi), take(state.id_lo), n_new,
    ), m - n_new


def compact(state: SimState) -> SimState:
    """Drop dead particles, close ranks (stable), reset survivors to ALIVE."""
    st, _ = reclaim(state)
    status = torch.full_like(st.status, STATUS_EMPTY)
    status[:st.n] = STATUS_ALIVE
    return st._replace(status=status)
