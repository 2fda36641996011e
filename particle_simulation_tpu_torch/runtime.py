"""Host-side simulation loop (counterpart of
``particle_simulation_tpu/runtime.py``): ``run_pic``, the reference's
runPIC (src/pic.cu:359-599), and the multiset keys every parity check uses.

The host owns the outer Poisson loop, as in the reference: each iteration
runs one Poisson step (field phase, mobility phase, compaction) and reads
back the step's counters.  The JAX package's capacity bucket ladder and
``run_pic_device`` are not ported: they exist for XLA's static shapes and
the TPU's remote dispatch, and the port already works on the live prefix.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import cross_section
from .config import SimConfig, float_dtype
from .ops.step import poisson_step
from .state import SimState, setup_particles
from .utils.profiling import span

# scheduler -> the reference's function name in its CSV (src/test.cu:12-15)
FUNCTION_NAMES = {
    "dynamic": "Dynamic", "sync": "CPU Sync",
    "naive": "Naive", "dynamic_old": "Dynamic Old",
}


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
    """Mirror of the reference's RunData/TimingData (src/utility.h:16-31)."""

    config: SimConfig
    final_n: int
    total_added: int
    total_removed: int
    device_time_ms: float      # host clock around the steps, each synchronised
    state: Optional[SimState]  # final (compacted) state; the benchmark sweep
    # drops it after recording
    steps: List[StepMetrics]

    @property
    def function(self) -> str:
        return FUNCTION_NAMES[self.config.scheduler]


def run_pic(
    config: SimConfig,
    table: Optional[torch.Tensor] = None,
    on_step: Optional[Callable[[int, SimState], None]] = None,
    print_header: bool = True,
    initial_state: Optional[SimState] = None,
    first_poisson_index: int = 0,
    auto_bucket: bool = False,
    *,
    device=None,
) -> RunData:
    """Run the full simulation per ``config``; the reference's runPIC.

    ``on_step(t, state)`` is the observability hook (verbose logging, PNG
    snapshots, checkpoints), called every ``config.verbose`` steps like the
    reference's log() (src/utility.cu:124-137), and once more after the
    last step when ``poisson_steps % verbose == 0``.  The Poisson index of
    step t is ``t + first_poisson_index`` (a resumed run passes the step it
    resumes at).  ``auto_bucket`` is accepted for the JAX signature and
    ignored: the results do not depend on the capacity.

    ``device`` places the table and the initial state that this call
    makes: the given state's device when None and a state is given, else
    the card (device.resolve).  A given table or state keeps its own
    device; a given state's floats must be of the config's type
    (``float_dtype``: ``checkpoint.load_npz`` and
    ``interop.state_from_numpy`` convert)."""
    del auto_bucket
    if initial_state is not None and (
            initial_state.pos.dtype != float_dtype(config)):
        raise ValueError(
            f"initial_state holds {initial_state.pos.dtype}, but "
            f"precision={config.precision!r} runs {float_dtype(config)}")
    if device is None and initial_state is not None:
        device = initial_state.device
    if print_header:
        print(
            f"PIC with\ninit n: {config.init_n}\ncapacity: {config.capacity}\n"
            f"poisson steps: {config.poisson_steps}\n"
            f"poisson_timestep: {config.poisson_timestep}\n"
            f"scheduler: {config.scheduler}"
        )
    with span("pst.run"):
        if table is None:
            table = cross_section.load_table(config.cross_section_path,
                                             device)
        state = (setup_particles(config, device=device)
                 if initial_state is None else initial_state)
        steps: List[StepMetrics] = []
        device_s = 0.0
        for t in range(config.poisson_steps):
            if (on_step is not None and config.verbose
                    and t % config.verbose == 0):
                on_step(t, state)
            t0 = time.perf_counter()
            with span("pst.step"):
                state, m = poisson_step(state, t + first_poisson_index,
                                        table, config)
            if state.device.type == "cuda":
                with span("pst.sync"):
                    torch.cuda.synchronize(state.device)
            dt = time.perf_counter() - t0
            device_s += dt
            steps.append(StepMetrics(
                step=t, n=m["n"], added=m["added"], removed=m["removed"],
                wall_s=dt, overflow=m["overflow"],
                pushes=m["pushes_lo"] + (m["pushes_hi"] << 30),
            ))
            if m["overflow"]:
                print("\n\nOVERFLOW FROM ADDING PARTICLES\n\n")
            if m["n"] == 0:
                print("Hit 0")
                break

        # the final log rides the per-step cadence gate: the reference's
        # end-of-run log(verbose, poisson_steps, ...) is a plain log() call
        # (src/pic.cu:561, src/utility.cu log's early return)
        if (on_step is not None and config.verbose
                and config.poisson_steps % config.verbose == 0):
            on_step(config.poisson_steps, state)

    total_added = sum(s.added for s in steps)
    total_removed = sum(s.removed for s in steps)
    if print_header:
        print(f"Final amount of particles: {state.n}")
        print(f"Particles added: {total_added}")
        print(f"Particles removed: {total_removed}")
        print(f"Device time of program: {device_s * 1e3:.3f} ms")
    return RunData(
        config=config, final_n=state.n, total_added=total_added,
        total_removed=total_removed, device_time_ms=device_s * 1e3,
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
