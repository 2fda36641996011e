"""The work-log engine (scheduler ``dynamic``): the CUDA kernel, its host
driver and its plain PyTorch version.

Counterpart of ``particle_simulation_tpu/ops/pallas/worklog.py``:

* ``_worklog_kernel`` + ``_sweep`` (one pass, one ``pallas_call``) ->
  ``worklog_pass`` here, which launches ``csrc/worklog.cu`` (sweep, scan,
  emit; the source note there says what bounds it on the H100);
* ``mobility_phase_worklog`` (ping-pong passes until the work log is empty;
  the done log is the next population) -> ``mobility_phase_worklog`` here;
* the plain version, ``mobility_phase_worklog_plain``: the naive cadence in
  torch (reclaiming dead rows mid-phase) followed by ``compact``.  It gives
  the same sorted multiset, ids and counters (the repo's cadence
  invariant: draws are keyed by genealogy).

``mobility_phase_worklog`` takes the plain version only for a state on the
CPU; for a CUDA state it launches the kernel or raises.

Records travel as (12, stride) int32 stacks in ``FIELD_NAMES`` order, with
float fields as bit patterns.  The TPU kernel's (8, 128) tiles, its
triangular-matmul ranks and its byte-split matmul scatter (the emission,
worklog.py:117-277) are not carried over: on the GPU the emission is an
order-preserving block scan.
"""

from __future__ import annotations

import torch

from ...config import SimConfig
from ...schedulers import mobility_phase_naive, pushes_info
from ...state import SimState
from .. import population
from .push_mcc import (
    BLOCK, NF, check_kernel_args, phys_args, stack_to_state, state_to_stack,
)


def work_capacity(config: SimConfig, capacity: int) -> int:
    """Records one work log holds: ``worklog_rows`` rows of 128 when set,
    else half the capacity (the JAX package's auto size).  A pass that
    emits more sets the overflow flag."""
    return config.worklog_rows * 128 if config.worklog_rows else max(capacity // 2, 1)


def worklog_pass(lib, src, src_stride: int, n_src: int, stage, code,
                 block_sums, offsets, totals, table, done, n_done_in: int,
                 work, config: SimConfig, poisson_step: int, t_steps: int):
    """Launch one work-log pass on the current stream: sweep ``n_src``
    records of ``src`` (updated in place), append finished records to
    ``done`` after ``n_done_in``, new work to ``work``.  ``totals``
    receives (done, work, children, pushes) of the pass."""
    for t in (src, stage, code, done, work):
        if t.device.type != "cuda" or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("work-log buffers must be contiguous int32 CUDA tensors")
    n_blocks = -(-n_src // BLOCK)
    if (n_src > src.shape[-1] or n_src > code.numel()
            or n_src > stage.shape[-1] or block_sums.shape[0] < n_blocks):
        raise ValueError("work-log scratch buffers too small for the pass")
    lib.call(
        "pst_worklog_pass",
        src.data_ptr(), src_stride, n_src,
        stage.data_ptr(), stage.shape[-1],
        code.data_ptr(), block_sums.data_ptr(), offsets.data_ptr(),
        totals.data_ptr(), table.data_ptr(),
        done.data_ptr(), done.shape[-1], n_done_in,
        work.data_ptr(), work.shape[-1],
        *phys_args(config, poisson_step, t_steps),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    worklog_pass.launches += 1


worklog_pass.launches = 0


def _mobility_phase_worklog_cuda(state: SimState, poisson_step: int, table,
                                 config: SimConfig, t_steps: int):
    from . import build

    device = state.device
    check_kernel_args(config, table, device)
    lib = build.load()
    c = state.capacity
    n0 = state.n_clamped
    w_cap = work_capacity(config, c)
    done = torch.zeros((NF, c), dtype=torch.int32, device=device)
    if n0 == 0:
        return stack_to_state(done, 0), {
            "added": 0, "removed": 0, "overflow": False, **pushes_info(0)
        }
    stride = max(c, w_cap)
    logs = [torch.empty((NF, w_cap), dtype=torch.int32, device=device)
            for _ in range(2)]
    stage = torch.empty((config.spawn_depth, NF, stride), dtype=torch.int32,
                        device=device)
    code = torch.empty(stride, dtype=torch.int32, device=device)
    n_blocks = -(-stride // BLOCK)
    block_sums = torch.empty((n_blocks, 4), dtype=torch.int64, device=device)
    offsets = torch.empty((n_blocks, 2), dtype=torch.int64, device=device)
    totals = torch.empty(4, dtype=torch.int64, device=device)

    n_done = children = pushes = passes = 0
    overflow = False
    src, n_src, target = state_to_stack(state), n0, 0
    while n_src > 0:
        # every record of pass k+1 starts at least one step later than the
        # earliest start of pass k, so a phase needs at most t_steps + 1
        passes += 1
        if passes > t_steps + 1:
            raise RuntimeError(
                f"work-log engine did not converge in {t_steps + 1} passes"
            )
        worklog_pass(lib, src, src.shape[-1], n_src, stage, code, block_sums,
                     offsets, totals, table, done, n_done, logs[target],
                     config, poisson_step, t_steps)
        d, w, ch, p = totals.tolist()  # the one readback of the pass
        n_done += d
        children += ch
        pushes += p
        if w > w_cap:
            overflow = True
            w = w_cap
        src, n_src, target = logs[target], w, 1 - target
    overflow = overflow or n_done > c
    n_live = min(n_done, c)
    return stack_to_state(done, n_live), {
        "added": children,
        "removed": n0 + children - n_live,
        "overflow": overflow,
        **pushes_info(pushes),
    }


def mobility_phase_worklog(state: SimState, poisson_step: int, table,
                           config: SimConfig, t_steps: int):
    """Work-list fixed point with in-kernel emission; returns the compacted
    state and info (added, removed, overflow, pushes_lo, pushes_hi)."""
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
