"""The work-log engine (scheduler ``dynamic``): the CUDA kernel, its host
driver and its plain PyTorch version.

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
(``push_mcc.compiled``), else the open one.

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
from ...schedulers import mobility_phase_naive, pushes_info
from ...state import SimState
from ...utils.profiling import span, span_if
from .. import population
from .push_mcc import (
    CHILD_WORDS, NF, check_buffers, check_f32, check_kernel_args, compiled,
    empty_state, model_bits, open_blocks, phys_args, state_buffers,
)

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


def work_capacity(config: SimConfig, capacity: int) -> int:
    """Records one work log holds: ``worklog_rows`` rows of 128 when set,
    else half the capacity (the JAX package's auto size).  A pass that
    emits more sets the overflow flag."""
    return config.worklog_rows * 128 if config.worklog_rows else max(capacity // 2, 1)


def scratch_shapes(config: SimConfig, capacity: int,
                   kid_blocks: int = 0) -> dict:
    """Shapes of the phase's scratch buffers: the two work logs, the
    look-back words (per region a ticket, then a done and a work word per
    tile of the largest pass) and the result words; with ``kid_blocks``,
    the open instantiation's children scratch for a grid of that many
    blocks (a Child a resident thread and depth).  Neither the spawn depth
    (but for that scratch) nor the number of passes sizes anything."""
    w_cap = work_capacity(config, capacity)
    tiles = -(-max(capacity, w_cap) // TILE)
    shapes = {
        "logs": (2, NF, w_cap),
        "lookback": (LOOKBACK_REGIONS, 1 + 2 * tiles),
        "result": (len(RESULT),),
    }
    if kid_blocks:
        shapes["kids"] = (config.spawn_depth, kid_blocks * TILE, CHILD_WORDS)
    return shapes


class PhaseBuffers(NamedTuple):
    """What the kernel writes: the output state (the done log) and its
    scratch."""

    out: SimState
    logs: torch.Tensor      # (2, 12, work_capacity) int32
    lookback: torch.Tensor  # (LOOKBACK_REGIONS, 1 + 2 * tiles) int64
    result: torch.Tensor    # (len(RESULT),) int64
    # the open instantiation's children (depth, threads, CHILD_WORDS)
    # int32; None launches the compiled one
    kids: Optional[torch.Tensor] = None


_DTYPES = {"logs": torch.int32, "lookback": torch.int64,
           "result": torch.int64, "kids": torch.int32}


def phase_buffers(state: SimState, config: SimConfig,
                  kid_blocks: int = 0) -> PhaseBuffers:
    """Uninitialised buffers for one phase on the state's device (the
    kernel zeroes what needs it); with ``kid_blocks``, for the open
    instantiation on a grid of that many blocks."""
    dev, c = state.device, state.capacity
    return PhaseBuffers(empty_state(c, dev), **{
        name: torch.empty(shape, dtype=_DTYPES[name], device=dev)
        for name, shape in scratch_shapes(config, c, kid_blocks).items()
    })


def _kid_blocks(bufs: PhaseBuffers) -> int:
    return 0 if bufs.kids is None else bufs.kids.shape[1] // TILE


def _check_buffers(state: SimState, bufs: PhaseBuffers,
                   config: SimConfig) -> None:
    c = state.capacity
    shapes = scratch_shapes(config, c, _kid_blocks(bufs))
    check_buffers("work-log phase", state.device, [
        *state_buffers("state", state, c), *state_buffers("out", bufs.out, c),
        *((name, getattr(bufs, name), _DTYPES[name], shape)
          for name, shape in shapes.items()),
    ])


def worklog_phase(lib, state: SimState, bufs: PhaseBuffers, table,
                  config: SimConfig, poisson_step: int, t_steps: int) -> None:
    """Launch one whole mobility phase on the current stream: the
    ``state.n_clamped`` records of ``state`` (read, never written) through
    every pass to the done log ``bufs.out``; ``bufs.result`` receives the
    ``RESULT`` words.  With ``bufs.kids`` the open instantiation runs (on
    as many blocks as the scratch was sized for), else the compiled one;
    any model but the reference launches the general instantiation, inside
    the span ``pst.mobility.general``.  Raises before any launch on a
    buffer the kernel does not take."""
    _check_buffers(state, bufs, config)
    out = bufs.out
    kids = (() if bufs.kids is None
            else (bufs.kids.data_ptr(), _kid_blocks(bufs)))
    general = model_bits(config) != 0
    with span("pst.mobility.launch"), span_if(general, "pst.mobility.general"):
        lib.call(
            "pst_worklog_phase_open" if kids else "pst_worklog_phase",
            state.pos.data_ptr(), state.vel.data_ptr(), state.acc.data_ptr(),
            state.status.data_ptr(), state.id_hi.data_ptr(),
            state.id_lo.data_ptr(), state.n_clamped,
            out.pos.data_ptr(), out.vel.data_ptr(), out.acc.data_ptr(),
            out.status.data_ptr(), out.id_hi.data_ptr(), out.id_lo.data_ptr(),
            state.capacity,
            bufs.logs.data_ptr(), bufs.logs.shape[-1],
            bufs.lookback.data_ptr(), (bufs.lookback.shape[1] - 1) // 2,
            bufs.result.data_ptr(), table.data_ptr(),
            *phys_args(config, poisson_step, t_steps), *kids,
            torch.cuda.current_stream(state.device).cuda_stream,
        )
    worklog_phase.launches += 1
    worklog_phase.open_launches += bool(kids)
    worklog_phase.general_launches += general


worklog_phase.launches = 0
worklog_phase.open_launches = 0  # of them, launches of the open instantiation
# of them, launches of the general instantiation, compiled or open
worklog_phase.general_launches = 0
worklog_phase.passes = 0  # passes the kernel counted, over every phase
worklog_phase.last = {}   # the last phase's RESULT words


def run_worklog_phase(state: SimState, bufs: PhaseBuffers, poisson_step: int,
                      table, config: SimConfig, t_steps: int):
    """One phase of a CUDA state with ``state.n_clamped > 0`` into
    ``bufs`` (``phase_buffers``: sized with ``kid_blocks``, they run the
    open instantiation, else the compiled one), then the one readback of the
    result words: ``mobility_phase_worklog``'s (state, info).  Raises
    where the phase did not converge."""
    from . import build

    n0, c = state.n_clamped, state.capacity
    worklog_phase(build.load(), state, bufs, table, config, poisson_step,
                  t_steps)
    with span("pst.mobility.readback"):
        r = dict(zip(RESULT, bufs.result.tolist()))  # the one readback
    worklog_phase.passes += r["passes"]
    worklog_phase.last = r
    if r["stuck"]:
        raise RuntimeError(
            f"work-log engine did not converge in {t_steps + 1} passes"
        )
    n_live = min(r["n_done"], c)
    return bufs.out._replace(n=n_live), {
        "added": r["children"],
        "removed": n0 + r["children"] - n_live,
        "overflow": bool(r["overflow"]) or r["n_done"] > c,
        **pushes_info(r["pushes"]),
    }


def _mobility_phase_worklog_cuda(state: SimState, poisson_step: int, table,
                                 config: SimConfig, t_steps: int):
    check_kernel_args(config, table, state.device)
    if state.n_clamped == 0:
        return SimState(*(torch.zeros_like(t) for t in state[:6]), n=0), {
            "added": 0, "removed": 0, "overflow": False, **pushes_info(0)
        }
    kid_blocks = (0 if compiled(config)
                  else open_blocks("worklog", config, state.device))
    with span("pst.mobility.alloc"):
        bufs = phase_buffers(state, config, kid_blocks)
    return run_worklog_phase(state, bufs, poisson_step, table, config,
                             t_steps)


def mobility_phase_worklog(state: SimState, poisson_step: int, table,
                           config: SimConfig, t_steps: int):
    """Work-list fixed point with in-kernel emission; returns the compacted
    state and info (added, removed, overflow, pushes_lo, pushes_hi).  A
    float64 state raises first."""
    check_f32(state, "work-log")
    if state.device.type == "cpu":
        return mobility_phase_worklog_plain(
            state, poisson_step, table, config, t_steps
        )
    if state.device.type != "cuda":
        raise ValueError(f"no work-log engine for device {state.device}")
    return _mobility_phase_worklog_cuda(
        state, poisson_step, table, config, t_steps
    )


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


mobility_phase_worklog.self_compacting = True
mobility_phase_worklog_plain.self_compacting = True
