"""Host driver (counterpart of ``particle_simulation_tpu/runtime.py``): a
minimal ``run_pic`` and the multiset key used by every parity check.  The
capacity bucket ladder, checkpoints and observability hooks are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from . import cross_section
from .config import SimConfig
from .ops.step import poisson_step
from .state import SimState, setup_particles


@dataclasses.dataclass
class StepMetrics:
    step: int
    n: int
    added: int
    removed: int
    wall_s: float
    overflow: bool
    pushes: int = 0


@dataclasses.dataclass
class RunData:
    config: SimConfig
    final_n: int
    total_added: int
    total_removed: int
    wall_ms: float          # host clock around the steps, each synchronised
    state: Optional[SimState]
    steps: List[StepMetrics]


def run_pic(config: SimConfig, table: Optional[torch.Tensor] = None,
            device=None, initial_state: Optional[SimState] = None) -> RunData:
    """Run ``config.poisson_steps`` Poisson steps (the reference's runPIC,
    src/pic.cu:359-599), stopping early when the population dies out.

    ``device`` (the card when None, device.resolve) places the table and
    the initial state that this call makes; a given table or state keeps
    its own device."""
    if table is None:
        table = cross_section.load_table(config.cross_section_path, device)
    state = (setup_particles(config, device=device)
             if initial_state is None else initial_state)
    steps: List[StepMetrics] = []
    for t in range(config.poisson_steps):
        t0 = time.perf_counter()
        state, m = poisson_step(state, t, table, config)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        steps.append(StepMetrics(
            step=t, n=m["n"], added=m["added"], removed=m["removed"],
            wall_s=time.perf_counter() - t0, overflow=m["overflow"],
            pushes=m["pushes_lo"] + (m["pushes_hi"] << 30),
        ))
        if m["n"] == 0:
            break
    return RunData(
        config=config, final_n=state.n,
        total_added=sum(s.added for s in steps),
        total_removed=sum(s.removed for s in steps),
        wall_ms=sum(s.wall_s for s in steps) * 1e3,
        state=state, steps=steps,
    )


def sorted_particle_array(state: SimState) -> np.ndarray:
    """Live particles sorted by the reference's key (timestamp, y, x, z, vy,
    vx, vz — src/electron.h:28-34), rows (status, pos, vel, acc) as in the
    JAX package's ``runtime.sorted_particle_array``."""
    n = state.n_clamped
    pos = state.pos[:n].cpu().numpy()
    vel = state.vel[:n].cpu().numpy()
    acc = state.acc[:n].cpu().numpy()
    status = state.status[:n].cpu().numpy()
    order = np.lexsort(
        (vel[:, 2], vel[:, 0], vel[:, 1], pos[:, 2], pos[:, 0], pos[:, 1],
         status)
    )
    return np.concatenate(
        [status[order, None].astype(pos.dtype), pos[order], vel[order],
         acc[order]],
        axis=1,
    )


def multiset_with_ids(state: SimState) -> np.ndarray:
    """Every field of the live particles, ids included, as int32 bit
    patterns with rows in lexicographic order: two states hold the same
    particle multiset iff these arrays are equal."""
    n = state.n_clamped
    cols = [
        state.pos[:n].contiguous().view(torch.int32),
        state.vel[:n].contiguous().view(torch.int32),
        state.acc[:n].contiguous().view(torch.int32),
        state.status[:n, None], state.id_hi[:n, None], state.id_lo[:n, None],
    ]
    rows = torch.cat(cols, dim=1).cpu().numpy()
    return rows[np.lexsort(rows.T[::-1])]
