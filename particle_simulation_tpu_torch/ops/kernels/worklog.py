"""The work-log engine (scheduler ``dynamic``): its CUDA kernel's layout,
its ``Engine`` record and its plain PyTorch version; ``engine.py`` drives
the kernel.

Counterpart of ``particle_simulation_tpu/ops/pallas/worklog.py``:

* ``_worklog_kernel`` + ``_sweep`` (one pass, one ``pallas_call``) and
  ``mobility_phase_worklog``'s ``lax.while_loop`` over passes ->
  ``worklog_phase`` here, which launches ``csrc/worklog.cu`` once for the
  whole phase: a persistent grid loops over the passes on the card (the
  source note there says what bounds it on the H100 and what the design
  does about it);
* ``mobility_phase_worklog`` -> ``mobility_phase_worklog`` here: buffers,
  the one launch and the one readback of the phase;
* the plain version, ``mobility_phase_worklog_plain``: the naive cadence in
  torch (reclaiming dead rows mid-phase) followed by ``compact``.  It gives
  the same sorted multiset, ids and counters (the repo's cadence
  invariant: draws are keyed by genealogy).

``mobility_phase_worklog`` takes the plain version only for a state on the
CPU; for a CUDA state it launches the kernel or raises: the compiled
instantiation of the spawn depth and round count where there is one
(``engine.compiled``), else the open one.

The kernel reads the caller's ``SimState`` tensors and writes the done log
straight into the output ``SimState``; the work logs between passes are
(12, work_capacity) int32 planes in ``FIELD_NAMES`` order, float fields as
bit patterns.  The TPU kernel's (8, 128) tiles, its triangular-matmul ranks
and its byte-split matmul scatter (the emission, worklog.py:117-277) are
not carried over: on the GPU the emission is a block scan and a decoupled
look-back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...config import SimConfig
from ...schedulers import mobility_phase_naive
from ...state import SimState
from .. import population
from .engine import CHILD_WORDS, NF, Engine, Phase, check_f32, pushes_info

# records a tile and threads a block of the phase kernel (-DPST_WORKLOG_TILE)
TILE = 384

# the words the kernel leaves in ``result``, in the order of kRes* in
# csrc/worklog.cu (the build passes their count, -DPST_WORKLOG_RESULT_WORDS,
# and the kernel checks it)
RESULT = ("n_done", "children", "pushes", "passes", "overflow", "stuck",
          "blocks")
# passes whose look-back words exist at once: kRegions in csrc/worklog.cu,
# which rotates them (-DPST_WORKLOG_REGIONS)
LOOKBACK_REGIONS = 3


def kernel_defines() -> list:
    """The work-log kernel's sizes as ``nvcc`` macro definitions."""
    return [
        f"-DPST_WORKLOG_TILE={TILE}",
        f"-DPST_WORKLOG_REGIONS={LOOKBACK_REGIONS}",
        f"-DPST_WORKLOG_RESULT_WORDS={len(RESULT)}",
    ]


def work_capacity(config: SimConfig, capacity: int) -> int:
    """Records one work log holds: ``worklog_rows`` rows of 128 when set,
    else half the capacity (the JAX package's auto size).  A pass that
    emits more sets the overflow flag."""
    return config.worklog_rows * 128 if config.worklog_rows else max(capacity // 2, 1)


def scratch_shapes(config: SimConfig, capacity: int,
                   kid_blocks: int = 0) -> dict:
    """Shapes and dtypes of the phase's scratch buffers: the two work logs,
    the look-back words (per region a ticket, then a done and a work word
    per tile of the largest pass) and the result words; with
    ``kid_blocks``, the open instantiation's children scratch for a grid of
    that many blocks (a Child a resident thread and depth).  Neither the
    spawn depth (but for that scratch) nor the number of passes sizes
    anything."""
    w_cap = work_capacity(config, capacity)
    tiles = -(-max(capacity, w_cap) // TILE)
    shapes = {
        "logs": ((2, NF, w_cap), torch.int32),
        "lookback": ((LOOKBACK_REGIONS, 1 + 2 * tiles), torch.int64),
        "result": ((len(RESULT),), torch.int64),
    }
    if kid_blocks:
        shapes["kids"] = ((config.spawn_depth, kid_blocks * TILE,
                           CHILD_WORDS), torch.int32)
    return shapes


class PhaseBuffers(NamedTuple):
    """What the kernel writes: the output state (the done log) and its
    scratch (``scratch_shapes``)."""

    out: SimState
    logs: torch.Tensor
    lookback: torch.Tensor
    result: torch.Tensor
    # the open instantiation's children; None launches the compiled one
    kids: Optional[torch.Tensor] = None


def _scratch_args(bufs: PhaseBuffers, config: SimConfig) -> tuple:
    return (bufs.logs.data_ptr(), bufs.logs.shape[-1],
            bufs.lookback.data_ptr(), (bufs.lookback.shape[1] - 1) // 2)


def _finish(state: SimState, out: SimState, r: dict):
    n0, c = state.n_clamped, state.capacity
    n_live = min(r["n_done"], c)
    return out._replace(n=n_live), {
        "added": r["children"],
        "removed": n0 + r["children"] - n_live,
        "overflow": bool(r["overflow"]) or r["n_done"] > c,
        **pushes_info(r["pushes"]),
    }


def mobility_phase_worklog_plain(state: SimState, poisson_step: int, table,
                                 config: SimConfig, t_steps: int):
    """The plain version: the naive cadence, then compaction; the same
    (compacted state, info) protocol as the kernel.

    Like the kernel, whose done log holds only live particles, it
    overflows only when the live population and a step's children exceed
    the capacity: dead rows are reclaimed mid-phase and counted back into
    added and removed."""
    check_f32(state, "work-log")
    n_start = state.n_clamped
    st, info = mobility_phase_naive(state, poisson_step, table, config,
                                    t_steps, reclaim=True)
    r = info["reclaimed"]
    compacted = population.compact(st)
    return compacted, {
        "added": st.n_clamped - n_start + r,
        "removed": st.n_clamped - compacted.n + r,
        "overflow": st.n > st.capacity,
        "pushes_lo": info["pushes_lo"],
        "pushes_hi": info["pushes_hi"],
    }


WORKLOG = Engine(
    name="worklog", label="work-log", tile=TILE, buffers=PhaseBuffers,
    scratch=scratch_shapes, scratch_args=_scratch_args,
    n0=lambda state: state.n_clamped, result=RESULT, finish=_finish,
    plain=mobility_phase_worklog_plain,
)
# the launch: (lib, state, bufs, table, config, poisson_step, t_steps), the
# ``state.n_clamped`` records through every pass to the done log
worklog_phase = Phase(WORKLOG)


def mobility_phase_worklog(state: SimState, poisson_step: int, table,
                           config: SimConfig, t_steps: int):
    """Work-list fixed point with in-kernel emission; returns the compacted
    state and info (added, removed, overflow, pushes_lo, pushes_hi).  A
    float64 state raises first."""
    return worklog_phase.mobility(state, poisson_step, table, config, t_steps)


mobility_phase_worklog.self_compacting = True
mobility_phase_worklog_plain.self_compacting = True
