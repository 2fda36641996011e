"""The staged engine (scheduler ``dynamic_old``) and the pieces of
``particle_simulation_tpu/ops/pallas/push_mcc.py`` that both engines share:
the record layout, the phase-internal status encodings and the kernels'
common arguments.

Counterpart of the JAX module:

* ``_mobility_kernel`` + ``_sweep_pass`` (one sweep, one ``pallas_call``)
  and ``_append_staged`` -> ``staged_pass`` here, which launches
  ``csrc/staged.cu`` (sweep, scan, append; the source note there says what
  bounds it on the H100), and ``staged_pass_plain``, the same pass in
  torch;
* ``_staged_reclaim_jit`` -> ``staged_reclaim``;
* ``mobility_phase_dynamic`` (passes until no lane is unfinished) ->
  ``mobility_phase_dynamic`` here, a host loop over passes with one
  readback each.  Like the JAX phase it is not self-compacting:
  ``ops.step.poisson_step`` compacts after it.

The port's host loop reclaims dead rows before an append that would not fit
(the JAX in-jit phase never reclaims, and its host variant only after the
append): the staged engine keeps dead rows in place until the step's
compaction, and at the main path one phase appends about as many children
as it holds live particles.  So it overflows only where the live
population and one pass's children exceed the capacity, as the work-log
engine does.  Reclaiming is exact: draws are keyed by genealogy, not slot.

The encodings are the single source of truth for the CUDA kernels too:
``build.py`` passes them to ``nvcc`` as macros (``kernel_defines``).  The
TPU lookup ``make_chunked_lookup`` is ported as its outcome
(``cross_section.table_lookup``, ``csrc/lookup.cuh``): every exact mode of
it returns what a direct ``table[energy_to_index(E)]`` read returns, and
its chunk sweeps exist because the TPU has no per-lane gather.

Records travel as (12, C) int32 stacks in ``FIELD_NAMES`` order, float
fields as bit patterns.  The JAX (rows, 128) field planes, their window
padding and the staging-budget depth clamp are not carried over: the
kernels are instantiated for spawn depths 1..4 and the wrappers raise
beyond them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import rng
from ...config import SimConfig
from ...constants import STATUS_DEAD, STATUS_EMPTY
from ...cross_section import BUCKET_SCALE, LOG10_E, N_STEPS
from ...schedulers import pushes_info
from ...state import SimState
from ..physics import Particles, f32, half_dt, update_particles
from ..population import is_live

FIELD_NAMES = (
    "px", "py", "pz", "vx", "vy", "vz", "ax", "ay", "az",
    "status", "id_hi", "id_lo",
)
NF = len(FIELD_NAMES)

BLOCK = 256          # threads per sweep / emit / append block (-DPST_BLOCK)
MAX_DEPTH = 4        # spawn depths the kernels are instantiated for
ROUNDS = (13, 20)    # Threefry round counts they are instantiated for

_INF_START = 0x7FFFFFF

# unfinished: -1 | s>0 | suspended (<= _SUS_BASE, packs resume step + stamp)
# finished:   (_SUS_BASE, _FIN_BASE] packs the original stamp (staged only)
_FIN_BASE = -10
_SUS_BASE = -40000
_STAMP_BITS = 15
_STAMP_MASK = (1 << _STAMP_BITS) - 1


def _encode_finished(stamp):
    return _FIN_BASE - (stamp + 2)


def _is_finished(s):
    return (s <= _FIN_BASE) & (s > _SUS_BASE)


def _decode_finished(s):
    return _FIN_BASE - s - 2


def _encode_suspended(resume, stamp):
    return _SUS_BASE - (((resume - 1) << _STAMP_BITS) | (stamp + 2))


def _is_suspended(s):
    return s <= _SUS_BASE


def _suspended_resume(s):
    return ((_SUS_BASE - s) >> _STAMP_BITS) + 1


def _suspended_stamp(s):
    return ((_SUS_BASE - s) & _STAMP_MASK) - 2


def _is_unfinished(s):
    return (s == -1) | (s > 0) | _is_suspended(s)


def kernel_defines() -> list:
    """The encodings as ``nvcc`` macro definitions."""
    return [
        f"-DPST_SUS_BASE={_SUS_BASE}",
        f"-DPST_FIN_BASE={_FIN_BASE}",
        f"-DPST_STAMP_BITS={_STAMP_BITS}",
        f"-DPST_INF_START={_INF_START}",
    ]


def state_to_stack(state: SimState) -> torch.Tensor:
    """SimState -> (12, C) int32 record stack."""
    as_i32 = lambda a: a.contiguous().view(torch.int32)
    return torch.cat([
        as_i32(state.pos).t(), as_i32(state.vel).t(), as_i32(state.acc).t(),
        state.status[None], state.id_hi[None], state.id_lo[None],
    ]).contiguous()


def stack_to_state(stack: torch.Tensor, n: int) -> SimState:
    """(12, C) int32 record stack -> SimState with ``n`` created slots."""
    vec3 = lambda rows: rows.t().contiguous().view(torch.float32)
    return SimState(
        pos=vec3(stack[0:3]), vel=vec3(stack[3:6]), acc=vec3(stack[6:9]),
        status=stack[9].clone(), id_hi=stack[10].clone(),
        id_lo=stack[11].clone(), n=n,
    )


def check_kernel_args(config: SimConfig, table: torch.Tensor, device):
    """Raise for what the compiled kernels do not take."""
    if not 1 <= config.spawn_depth <= MAX_DEPTH:
        raise ValueError(
            f"spawn_depth={config.spawn_depth}: the kernel is built for "
            f"1..{MAX_DEPTH}"
        )
    if config.rng_rounds not in ROUNDS:
        raise ValueError(
            f"rng_rounds={config.rng_rounds}: the kernel is built for {ROUNDS}"
        )
    if (table.device != device or table.dtype != torch.float32
            or table.shape != (N_STEPS, 2) or not table.is_contiguous()):
        raise ValueError(
            "the table must be a contiguous float32 (10000, 2) tensor on "
            f"{device}"
        )


def phys_args(config: SimConfig, poisson_step: int, t_steps: int) -> tuple:
    """The kernels' physics arguments: dt, half_dt, sim_size, log10_e,
    bucket_scale, seed, poisson_step, t_steps, spawn_depth, rounds,
    block2."""
    sx, sy, sz = (f32(s) for s in config.sim_size)
    return (
        f32(config.mobility_dt), half_dt(config.mobility_dt), sx, sy, sz,
        float(LOG10_E), float(BUCKET_SCALE),
        config.seed & rng.MASK, poisson_step & rng.MASK, t_steps,
        config.spawn_depth, config.rng_rounds,
        int(config.rng_mode == "block2"),
    )


# ---------------------------------------------------------------------------
# the staged engine


class PassTotals(NamedTuple):
    """What one pass leaves: the new created-slot count and its counts."""

    n: int           # created slots after the append (may exceed C)
    children: int    # children staged (appended or dropped)
    appended: int    # of them, the ones that fit
    pushes: int      # lanes advanced, summed over the pass's steps
    suspended: int   # lanes left suspended
    reclaimed: int   # dead rows dropped before the append


def staged_reclaim(stack: torch.Tensor, n: int):
    """Mid-phase reclamation in the record stack, in place: drop the DEAD
    and EMPTY rows below ``n`` and close ranks (stable), keeping every other
    status verbatim (unfinished, suspended and finished encodings still mean
    something inside the fixed point; ``population.reclaim`` keeps only
    live rows).  Returns (new n, rows reclaimed)."""
    m = min(n, stack.shape[1])
    status = stack[9, :m]
    keep = torch.nonzero((status != STATUS_DEAD)
                         & (status != STATUS_EMPTY)).flatten()
    n_new = keep.numel()
    stack[:, :n_new] = stack[:, keep]
    stack[:, n_new:m] = 0
    staged_reclaim.calls += 1
    return n_new, m - n_new


staged_reclaim.calls = 0


def _reclaim_for(stack, n: int, k: int, dead: int):
    """The pre-append rule: reclaim when ``k`` children would not fit and
    dead rows could make room (never past an overflow, whose count of
    dropped children lives in ``n``)."""
    c = stack.shape[1]
    if n <= c and n + k > c and dead > 0:
        return staged_reclaim(stack, n)
    return n, 0


def _pass_end(stack, n, k, pushes, suspended, reclaimed):
    appended = max(0, min(k, stack.shape[1] - n))
    return PassTotals(n + k, k, appended, pushes, suspended, reclaimed)


def _stage_rec(p: Particles) -> torch.Tensor:
    """A Particles bundle -> (12, u) int32 records."""
    f = torch.stack([p.px, p.py, p.pz, p.vx, p.vy, p.vz,
                     p.ax, p.ay, p.az]).view(torch.int32)
    return torch.cat([f, torch.stack([p.status, p.id_hi, p.id_lo])])


def staged_pass_plain(stack: torch.Tensor, n: int, table, config: SimConfig,
                      poisson_step: int, t_steps: int) -> PassTotals:
    """One pass in torch, on any device: ``_mobility_kernel``'s body over
    the unfinished lanes among slots [0, n) (gathered first, looped from
    their earliest start), written back in place; then the pre-append
    reclaim and the append of the staged children at [n, n+k), depth-major
    then slot order, dropping those at or beyond the capacity."""
    m = min(n, stack.shape[1])
    depth_max = config.spawn_depth
    idx = torch.nonzero(_is_unfinished(stack[9, :m])).flatten()
    u = idx.numel()
    pushes = suspended = 0
    staged = stack.new_zeros((NF, 0))
    if u:
        rec = stack[:, idx]
        f = rec[:9].view(torch.float32)
        s0 = rec[9]
        susp = _is_suspended(s0)
        start = torch.where(s0 == -1, 1, torch.where(
            s0 > 0, s0 + 1, _suspended_resume(s0)))
        p = Particles(*f, status=torch.where(susp, _suspended_stamp(s0), s0),
                      id_hi=rec[10], id_lo=rec[11])
        depth = torch.zeros_like(s0)
        stage = torch.zeros((depth_max, NF, u), dtype=torch.int32,
                            device=stack.device)
        moved = torch.zeros((), dtype=torch.int64, device=stack.device)
        for t in range(int(start.min()), t_steps + 1):
            # the tile loop's exit: no lane live and not suspended
            if not bool((p.status >= -1).any()):
                break
            candidate = (p.status >= -1) & (t >= start)
            suspend_now = candidate & (depth >= depth_max)
            active = candidate & ~suspend_now
            res = update_particles(
                p, active=active, t=t, poisson_step=poisson_step,
                dt=config.mobility_dt, sim_size=config.sim_size,
                seed=config.seed, table=table, rng_rounds=config.rng_rounds,
                rng_mode=config.rng_mode,
            )
            child = _stage_rec(res.child)
            for d in range(depth_max):
                sel = res.spawn & (depth == d)
                stage[d] = torch.where(sel, child, stage[d])
            depth = depth + res.spawn.to(torch.int32)
            moved += active.sum()
            q = res.particles
            p = q._replace(status=torch.where(
                suspend_now, _encode_suspended(t, q.status), q.status))
        stamp = p.status
        out = _stage_rec(p._replace(status=torch.where(
            is_live(stamp), _encode_finished(stamp), stamp)))
        stack[:6, idx] = out[:6]
        stack[9, idx] = out[9]
        pushes = int(moved)
        staged = torch.cat([stage[d][:, depth > d]
                            for d in range(depth_max)], dim=1)
        suspended = int(_is_suspended(stamp).sum())
    k = staged.shape[1]
    dead = int((stack[9, :m] == STATUS_DEAD).sum())
    n, reclaimed = _reclaim_for(stack, n, k, dead)
    keep = max(0, min(k, stack.shape[1] - n))
    stack[:, n:n + keep] = staged[:, :keep]
    return _pass_end(stack, n, k, pushes, suspended, reclaimed)


class _Scratch:
    """Device buffers of the staged kernels for one phase."""

    def __init__(self, c: int, depth: int, dev: torch.device):
        n_blocks = -(-c // BLOCK)
        self.stage = torch.empty((depth, NF, c), dtype=torch.int32, device=dev)
        self.code = torch.empty(c, dtype=torch.int32, device=dev)
        # per block: children at depths 0..3, pushes, suspended, dead, pad
        # (kNCol in staged.cu); totals: the same eight, summed
        self.block_sums = torch.empty((n_blocks, 8), dtype=torch.int64,
                                      device=dev)
        self.offsets = torch.empty((n_blocks, MAX_DEPTH), dtype=torch.int64,
                                   device=dev)
        self.totals = torch.empty(8, dtype=torch.int64, device=dev)


def staged_pass(lib, stack: torch.Tensor, n: int, scratch: _Scratch, table,
                config: SimConfig, poisson_step: int,
                t_steps: int) -> PassTotals:
    """One pass through ``csrc/staged.cu`` on the current stream: the sweep
    and scan kernels over slots [0, n), the pass's one readback, the
    pre-append reclaim, and the append kernel."""
    c = stack.shape[1]
    if (stack.device.type != "cuda" or stack.dtype != torch.int32
            or not stack.is_contiguous() or stack.shape[0] != NF):
        raise ValueError("the record stack must be a contiguous (12, C) "
                         "int32 CUDA tensor")
    if scratch.stage.shape != (config.spawn_depth, NF, c):
        raise ValueError("staged scratch buffers do not match the stack")
    m = min(n, c)
    stream = torch.cuda.current_stream(stack.device).cuda_stream
    lib.call(
        "pst_staged_sweep",
        stack.data_ptr(), c, m, scratch.stage.data_ptr(),
        scratch.code.data_ptr(), scratch.block_sums.data_ptr(),
        scratch.offsets.data_ptr(), scratch.totals.data_ptr(),
        table.data_ptr(), *phys_args(config, poisson_step, t_steps), stream,
    )
    staged_pass.launches += 1
    totals = scratch.totals.tolist()  # the one readback of the pass
    k = sum(totals[:MAX_DEPTH])
    pushes, suspended, dead = totals[4:7]
    n, reclaimed = _reclaim_for(stack, n, k, dead)
    if k and n < c:
        lib.call(
            "pst_staged_append",
            scratch.stage.data_ptr(), c, m, scratch.code.data_ptr(),
            scratch.offsets.data_ptr(), scratch.totals.data_ptr(),
            config.spawn_depth, stack.data_ptr(), n, stream,
        )
    return _pass_end(stack, n, k, pushes, suspended, reclaimed)


staged_pass.launches = 0


def _staged_checks(state: SimState, t_steps: int) -> None:
    if state.pos.dtype != torch.float32:
        raise ValueError("the staged engine is float32-only")
    # suspended statuses pack (resume step, spawn stamp) into 15 bits each;
    # beyond that the encodings would alias and corrupt physics
    if t_steps + 2 >= (1 << _STAMP_BITS):
        raise ValueError(
            f"t_steps={t_steps} exceeds the staged engine's "
            f"{_STAMP_BITS}-bit stamp domain; use scheduler='naive' or 'sync'"
        )


def _run_phase(state: SimState, t_steps: int, run_pass):
    """The work-list fixed point: passes until no lane is unfinished, then
    the finished markers decoded back to the reference's stamps."""
    _staged_checks(state, t_steps)
    stack = state_to_stack(state)
    n = state.n
    pushes = reclaimed = passes = 0
    more = state.n_clamped > 0
    while more:
        # every unfinished lane of pass k+1 starts later than the earliest
        # start of pass k, so a phase needs at most t_steps + 1 passes
        passes += 1
        if passes > t_steps + 1:
            raise RuntimeError(
                f"staged engine did not converge in {t_steps + 1} passes"
            )
        tot = run_pass(stack, n)
        n = tot.n
        pushes += tot.pushes
        reclaimed += tot.reclaimed
        more = tot.suspended > 0 or tot.appended > 0
    m = min(n, stack.shape[1])
    s = stack[9, :m]
    stack[9, :m] = torch.where(_is_finished(s), _decode_finished(s), s)
    return stack_to_state(stack, n), {
        "reclaimed": reclaimed, **pushes_info(pushes),
    }


def mobility_phase_dynamic(state: SimState, poisson_step: int, table,
                           config: SimConfig, t_steps: int):
    """Work-list fixed point over staged sweep passes; returns the
    uncompacted state and info (pushes_lo, pushes_hi, reclaimed).  A CPU
    state takes the plain passes; a CUDA state launches the kernels or
    raises."""
    if state.device.type == "cpu":
        return mobility_phase_dynamic_plain(
            state, poisson_step, table, config, t_steps
        )
    if state.device.type != "cuda":
        raise ValueError(f"no staged engine for device {state.device}")
    from . import build

    check_kernel_args(config, table, state.device)
    lib = build.load()
    scratch = _Scratch(state.capacity, config.spawn_depth, state.device)

    def run_pass(stack, n):
        return staged_pass(lib, stack, n, scratch, table, config,
                           poisson_step, t_steps)

    return _run_phase(state, t_steps, run_pass)


def mobility_phase_dynamic_plain(state: SimState, poisson_step: int, table,
                                 config: SimConfig, t_steps: int):
    """The same host loop over ``staged_pass_plain``, on any device."""

    def run_pass(stack, n):
        return staged_pass_plain(stack, n, table, config, poisson_step,
                                 t_steps)

    return _run_phase(state, t_steps, run_pass)
