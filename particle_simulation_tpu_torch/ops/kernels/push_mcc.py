"""The staged engine (scheduler ``dynamic_old``) and the pieces of
``particle_simulation_tpu/ops/pallas/push_mcc.py`` that both engines share:
the record layout, the phase-internal status encodings and the kernels'
common arguments.

Counterpart of the JAX module:

* ``_mobility_kernel`` + ``_sweep_pass`` (one sweep, one ``pallas_call``),
  ``_append_staged`` and ``mobility_phase_dynamic``'s loop over passes ->
  ``staged_phase`` here, which launches ``csrc/staged.cu`` once for the
  whole phase: a persistent grid runs every pass, the reclaim and the final
  compaction on the card (the source note there says what bounds it on the
  H100 and what each sub-phase does about it);
* ``mobility_phase_dynamic`` -> ``mobility_phase_dynamic`` here: buffers,
  the one launch and the one readback of the phase;
* the plain version, ``mobility_phase_dynamic_plain``: a host loop over
  ``staged_pass_plain`` (the same pass in torch) with ``staged_reclaim``
  (``_staged_reclaim_jit``), then the finished markers decoded and
  ``population.compact``.

Both phases are self-compacting: they return the compacted state, with
``added``, ``removed`` and ``overflow`` (as the work-log engine does), and
``reclaimed``.  The JAX phase is not: its ``poisson_step`` compacts after
it, which gives the same state and counters.

The engine reclaims dead rows before an append that would not fit (the JAX
in-jit phase never reclaims, and its host variant only after the append):
the staged engine keeps dead rows in place until the phase ends, and at
the main path one phase appends about as many children as it holds live
particles.  So it overflows only where the live population and one pass's
children exceed the capacity, as the work-log engine does.  Reclaiming is
exact: draws are keyed by genealogy, not slot.

The encodings are the single source of truth for the CUDA kernels too:
``build.py`` passes them to ``nvcc`` as macros (``kernel_defines``).  The
TPU lookup ``make_chunked_lookup`` is ported as its outcome
(``cross_section.table_lookup``, ``csrc/lookup.cuh``): every exact mode of
it returns what a direct ``table[energy_to_index(E)]`` read returns, and
its chunk sweeps exist because the TPU has no per-lane gather.

The model menu (integrator, b_field, collision_model, boundary) reaches
both kernels through ``phys_args``: the ``MODEL_BITS`` of the selection and
the boris rotation's constants.  Model 0, the reference, launches the
instantiations of the main path; any other the general ones
(csrc/physics.cuh).  The plain versions call ``update_particles`` with the
same selection (``physics.model_args``).

Records travel as (12, C) int32 stacks in ``FIELD_NAMES`` order, float
fields as bit patterns.  The JAX (rows, 128) field planes, their window
padding and the staging-budget depth clamp are not carried over: the port
honours ``spawn_depth`` exactly.  Both kernels are compiled for spawn
depths 1..4 and Threefry rounds 13 and 20 (``compiled``), the children in
registers; every other (depth, rounds) runs their open instantiation,
which reads both at run time and keeps a lane's children in a scratch
buffer sized by the resident grid (``open_blocks``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ... import rng
from ...config import SimConfig, f32_only
from ...constants import STATUS_DEAD, STATUS_EMPTY
from ...cross_section import BUCKET_SCALE, LOG10_E, N_STEPS
from ...schedulers import pushes_info
from ...state import SimState
from ...utils.profiling import span, span_if
from .. import population
from ..physics import (
    Particles, half, model_args, rotation, scalar, update_particles,
)
from ..population import is_live

FIELD_NAMES = (
    "px", "py", "pz", "vx", "vy", "vz", "ax", "ay", "az",
    "status", "id_hi", "id_lo",
)
NF = len(FIELD_NAMES)

MAX_DEPTH = 4        # spawn depths 1..MAX_DEPTH are compiled instantiations
ROUNDS = (13, 20)    # and so are these Threefry round counts
CHILD_WORDS = 9      # a Child of csrc/physics.cuh: 6 floats, stamp, id words

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
    """The encodings and the staged kernel's sizes as ``nvcc`` macro
    definitions."""
    return [
        f"-DPST_SUS_BASE={_SUS_BASE}",
        f"-DPST_FIN_BASE={_FIN_BASE}",
        f"-DPST_STAMP_BITS={_STAMP_BITS}",
        f"-DPST_INF_START={_INF_START}",
        f"-DPST_STAGED_TILE={STAGED_TILE}",
        f"-DPST_STAGED_ITEMS={SCAN_ITEMS}",
        f"-DPST_STAGED_REGIONS={STAGED_REGIONS}",
        f"-DPST_STAGED_HEADER={REGION_HEADER}",
        f"-DPST_STAGED_RESULT_WORDS={len(STAGED_RESULT)}",
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


def check_f32(state: SimState, engine: str) -> None:
    """Raise ValueError for a float64 state (``precision="f64"``), with
    the JAX package's message, before any buffer or launch."""
    if state.pos.dtype != torch.float32 or state.vel.dtype != torch.float32:
        raise ValueError(f32_only(engine))


def compiled(config: SimConfig) -> bool:
    """Whether the kernels have a compiled instantiation for the spawn
    depth and the round count; any other pair runs the open one."""
    return 1 <= config.spawn_depth <= MAX_DEPTH and config.rng_rounds in ROUNDS


def check_kernel_args(config: SimConfig, table: torch.Tensor, device):
    """Raise for what the kernels do not take: a spawn depth below 1 (as
    ``config.check_supported`` does) or a table that is not a contiguous
    float32 (10000, 2) tensor on ``device``."""
    if config.spawn_depth < 1:
        raise ValueError(f"spawn_depth={config.spawn_depth} must be >= 1")
    if (table.device != device or table.dtype != torch.float32
            or table.shape != (N_STEPS, 2) or not table.is_contiguous()):
        raise ValueError(
            "the table must be a contiguous float32 (10000, 2) tensor on "
            f"{device}"
        )


@functools.lru_cache(maxsize=None)
def _resident_blocks(symbol: str, device_index: int, *args) -> int:
    from . import build

    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.load().call(symbol, *args, ctypes.addressof(blocks))
    return blocks.value


def open_blocks(engine: str, config: SimConfig, device) -> int:
    """The grid of ``engine``'s ("worklog" or "staged") open instantiation
    at ``config``'s draw protocol, model and spawn depth on CUDA
    ``device``: the blocks that can be resident at once, which its launch
    takes and its children scratch is sized for (queried once a device).
    Raises, with the depth and the shared memory, where a block does not
    fit an SM."""
    block2 = int(config.rng_mode == "block2")
    general = int(model_bits(config) != 0)
    index = torch.device(device).index or 0
    extra = (config.spawn_depth,) if engine == "staged" else ()
    try:
        return _resident_blocks(f"pst_{engine}_open_blocks", index, block2,
                                general, *extra)
    except RuntimeError as e:
        smem = N_STEPS * 8 + 8 * config.spawn_depth * (engine == "staged")
        raise RuntimeError(
            f"the {engine} engine's open instantiation at spawn_depth="
            f"{config.spawn_depth} ({smem} B of dynamic shared memory a "
            f"block) has no resident grid: {e}") from e


# the bits of PhysConsts::model (csrc/physics.cuh kBoris ... kPeriodic); 0,
# the reference model, runs the kernels' reference instantiations, any
# other value their general ones
MODEL_BITS = {"boris": 1, "magnetized": 2, "isotropic": 4, "periodic": 8}


def model_bits(config: SimConfig) -> int:
    """The model selections of ``config`` as PhysConsts::model bits."""
    boris = config.integrator == "boris"
    return (MODEL_BITS["boris"] * boris
            | MODEL_BITS["magnetized"] * (
                boris and rotation(config.b_field, config.mobility_dt)
                is not None)
            | MODEL_BITS["isotropic"] * (config.collision_model == "isotropic")
            | MODEL_BITS["periodic"] * (config.boundary == "periodic"))


def phys_args(config: SimConfig, poisson_step: int, t_steps: int) -> tuple:
    """The kernels' physics arguments: dt, half_dt, sim_size, log10_e,
    bucket_scale, seed, poisson_step, t_steps, spawn_depth, rounds,
    block2, the model bits and the boris rotation's t and s (zeros without
    a field)."""
    sx, sy, sz = (scalar(s) for s in config.sim_size)
    bits = model_bits(config)
    rot = (rotation(config.b_field, config.mobility_dt)
           if bits & MODEL_BITS["magnetized"] else ((0.0,) * 3,) * 2)
    return (
        scalar(config.mobility_dt), half(config.mobility_dt), sx, sy, sz,
        float(LOG10_E), float(BUCKET_SCALE),
        config.seed & rng.MASK, poisson_step & rng.MASK, t_steps,
        config.spawn_depth, config.rng_rounds,
        int(config.rng_mode == "block2"), bits, *rot[0], *rot[1],
    )


def empty_state(capacity: int, device) -> SimState:
    """An uninitialised state of ``capacity`` slots on ``device``, n = 0:
    the output a phase kernel writes."""
    vec3 = lambda: torch.empty((capacity, 3), dtype=torch.float32,
                               device=device)
    word = lambda: torch.empty((capacity,), dtype=torch.int32, device=device)
    return SimState(vec3(), vec3(), vec3(), word(), word(), word(), n=0)


def state_buffers(prefix: str, st: SimState, c: int) -> list:
    """The (name, tensor, dtype, shape) entries of a state's six tensors at
    capacity ``c``, for ``check_buffers``."""
    return [
        *((f"{prefix}.{f}", getattr(st, f), torch.float32, (c, 3))
          for f in ("pos", "vel", "acc")),
        *((f"{prefix}.{f}", getattr(st, f), torch.int32, (c,))
          for f in ("status", "id_hi", "id_lo")),
    ]


def check_buffers(what: str, device: torch.device, want: list) -> None:
    """Raise ValueError unless every (name, tensor, dtype, shape) of
    ``want`` is a contiguous CUDA tensor of that dtype and shape on
    ``device``: each property over every buffer, the device last."""
    faults = (
        lambda t, dtype, shape: t.dtype != dtype and f"dtype {t.dtype}",
        lambda t, dtype, shape: (tuple(t.shape) != shape
                                 and f"shape {tuple(t.shape)}"),
        lambda t, dtype, shape: not t.is_contiguous() and "not contiguous",
        lambda t, dtype, shape: ((t.device.type != "cuda"
                                  or t.device != device)
                                 and f"on {t.device}"),
    )
    for fault in faults:
        for name, t, dtype, shape in want:
            why = fault(t, dtype, shape)
            if why:
                raise ValueError(
                    f"{what}: {name} must be a contiguous {dtype} CUDA "
                    f"tensor of shape {shape} on the state's device; it is "
                    f"{why}")


# ---------------------------------------------------------------------------
# the staged engine: the plain version


class PassTotals(NamedTuple):
    """What one pass leaves: the new created-slot count and its counts."""

    n: int           # created slots after the append (may exceed C)
    children: int    # children staged (appended or dropped)
    appended: int    # of them, the ones that fit
    pushes: int      # lanes advanced, summed over the pass's steps
    suspended: int   # lanes left suspended
    died: int        # lanes that died in this pass
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
    return n_new, m - n_new


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
    reclaim (when ``k`` children would not fit and dead rows could make
    room, never past an overflow, whose count of dropped children lives in
    ``n``) and the append of the staged children at [n, n+k), depth-major
    then slot order, dropping those at or beyond the capacity."""
    c = stack.shape[1]
    m = min(n, c)
    depth_max = config.spawn_depth
    idx = torch.nonzero(_is_unfinished(stack[9, :m])).flatten()
    u = idx.numel()
    pushes = suspended = died = 0
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
                rng_mode=config.rng_mode, **model_args(config),
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
        died = int((stamp == STATUS_DEAD).sum())
    k = staged.shape[1]
    reclaimed = 0
    if n <= c and n + k > c and bool((stack[9, :m] == STATUS_DEAD).any()):
        n, reclaimed = staged_reclaim(stack, n)
    appended = max(0, min(k, c - n))
    stack[:, n:n + appended] = staged[:, :appended]
    return PassTotals(n + k, k, appended, pushes, suspended, died, reclaimed)


def _staged_checks(state: SimState, t_steps: int) -> None:
    check_f32(state, "staged")
    # suspended statuses pack (resume step, spawn stamp) into 15 bits each;
    # beyond that the encodings would alias and corrupt physics
    if t_steps + 2 >= (1 << _STAMP_BITS):
        raise ValueError(
            f"t_steps={t_steps} exceeds the staged engine's "
            f"{_STAMP_BITS}-bit stamp domain; use scheduler='naive' or 'sync'"
        )


def _not_converged(t_steps: int) -> RuntimeError:
    return RuntimeError(
        f"staged engine did not converge in {t_steps + 1} passes")


def staged_fixed_point(state: SimState, poisson_step: int, table,
                       config: SimConfig, t_steps: int):
    """The work-list fixed point on the host, on any device: plain passes
    until no lane is suspended and nothing was appended, then the finished
    markers decoded back to the reference's stamps.  Returns the
    uncompacted state (dead rows in place) and its counts: reclaimed,
    pushes, passes."""
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
            raise _not_converged(t_steps)
        tot = staged_pass_plain(stack, n, table, config, poisson_step, t_steps)
        n = tot.n
        pushes += tot.pushes
        reclaimed += tot.reclaimed
        more = tot.suspended > 0 or tot.appended > 0
    m = min(n, stack.shape[1])
    s = stack[9, :m]
    stack[9, :m] = torch.where(_is_finished(s), _decode_finished(s), s)
    return stack_to_state(stack, n), {
        "reclaimed": reclaimed, "pushes": pushes, "passes": passes,
    }


def _phase_info(n_start: int, n: int, capacity: int, n_live: int,
                reclaimed: int, pushes: int, passes: int) -> dict:
    """A self-compacting phase's info from its counts: ``n`` created slots
    at the end (dropped children included), ``n_live`` rows kept, and the
    rows its reclaims dropped, folded back into added and removed."""
    n_clamped = min(n, capacity)
    return {
        "added": n_clamped - n_start + reclaimed,
        "removed": n_clamped - n_live + reclaimed,
        "overflow": n > capacity,
        "reclaimed": reclaimed,
        "passes": passes,
        **pushes_info(pushes),
    }


def mobility_phase_dynamic_plain(state: SimState, poisson_step: int, table,
                                 config: SimConfig, t_steps: int):
    """The plain version: ``staged_fixed_point``, then
    ``population.compact``; the same (compacted state, info) protocol as
    the kernel."""
    st, c = staged_fixed_point(state, poisson_step, table, config, t_steps)
    out = population.compact(st)
    return out, _phase_info(state.n_clamped, st.n, st.capacity, out.n,
                            c["reclaimed"], c["pushes"], c["passes"])


# ---------------------------------------------------------------------------
# the staged engine: the CUDA kernel


STAGED_TILE = 384    # lanes a sweep tile, threads a block (-DPST_STAGED_TILE)
SCAN_ITEMS = 16      # slots a thread takes in a scan tile (-DPST_STAGED_ITEMS)
# look-back regions that exist at once (kRegions in csrc/staged.cu, which
# rotates them over the sub-phases: -DPST_STAGED_REGIONS); each starts with
# a ticket and a counter (-DPST_STAGED_HEADER)
STAGED_REGIONS = 3
REGION_HEADER = 2
# the words the kernel leaves in ``result``, in the order of kRes* in
# csrc/staged.cu (the build passes their count and the kernel checks it)
STAGED_RESULT = ("n", "n_live", "pushes", "passes", "reclaimed", "reclaims",
                 "stuck", "blocks")


def staged_scratch_shapes(capacity: int, depth: int,
                          kid_blocks: int = 0) -> dict:
    """Shapes of the phase's scratch buffers: two record stacks (the
    reclaim compacts one into the other), two sets of staging regions of C
    children a depth and two work lists (a pass reads one and writes the
    other), the look-back words (per region a ticket, a counter, then a
    word per stream and sweep tile of C slots: a stream per depth and one
    for the suspended lanes) and the result words; with ``kid_blocks``, the
    open instantiation's children scratch for a grid of that many blocks.
    The number of passes sizes nothing."""
    tiles = -(-capacity // STAGED_TILE)
    shapes = {
        "stacks": (2, NF, capacity),
        "stage": (2, depth, NF, capacity),
        "list": (2, capacity),
        "lookback": (STAGED_REGIONS, REGION_HEADER + (depth + 1) * tiles),
        "result": (len(STAGED_RESULT),),
    }
    if kid_blocks:
        shapes["kids"] = (depth, kid_blocks * STAGED_TILE, CHILD_WORDS)
    return shapes


class StagedBuffers(NamedTuple):
    """What the kernel writes: the output state and its scratch."""

    out: SimState
    stacks: torch.Tensor    # (2, 12, C) int32
    stage: torch.Tensor     # (2, depth, 12, C) int32
    list: torch.Tensor      # (2, C) int32
    lookback: torch.Tensor  # (regions, header + (depth + 1) * tiles) int64
    result: torch.Tensor    # (len(STAGED_RESULT),) int64
    # the open instantiation's children (depth, threads, CHILD_WORDS)
    # int32; None launches the compiled one
    kids: Optional[torch.Tensor] = None


_SCRATCH_DTYPES = {"stacks": torch.int32, "stage": torch.int32,
                   "list": torch.int32, "lookback": torch.int64,
                   "result": torch.int64, "kids": torch.int32}


def staged_buffers(state: SimState, config: SimConfig,
                   kid_blocks: int = 0) -> StagedBuffers:
    """Uninitialised buffers for one phase on the state's device (the
    kernel writes or zeroes what it reads); with ``kid_blocks``, for the
    open instantiation on a grid of that many blocks."""
    shapes = staged_scratch_shapes(state.capacity, config.spawn_depth,
                                   kid_blocks)
    return StagedBuffers(empty_state(state.capacity, state.device), **{
        name: torch.empty(shape, dtype=_SCRATCH_DTYPES[name],
                          device=state.device)
        for name, shape in shapes.items()
    })


def staged_phase(lib, state: SimState, bufs: StagedBuffers, table,
                 config: SimConfig, poisson_step: int, t_steps: int) -> None:
    """Launch one whole staged mobility phase on the current stream: the
    ``state.n`` created slots of ``state`` (read, never written) through
    every pass, reclaim and append to the compacted output ``bufs.out``;
    ``bufs.result`` receives the ``STAGED_RESULT`` words.  With
    ``bufs.kids`` the open instantiation runs (on as many blocks as the
    scratch was sized for), else the compiled one; any model but the
    reference launches the general instantiation, inside the span
    ``pst.mobility.general``.  Raises before any launch on a buffer the
    kernel does not take."""
    kid_blocks = 0 if bufs.kids is None else bufs.kids.shape[1] // STAGED_TILE
    shapes = staged_scratch_shapes(state.capacity, config.spawn_depth,
                                   kid_blocks)
    check_buffers("staged phase", state.device, [
        *state_buffers("state", state, state.capacity),
        *state_buffers("out", bufs.out, state.capacity),
        *((name, getattr(bufs, name), _SCRATCH_DTYPES[name], shape)
          for name, shape in shapes.items()),
    ])
    out = bufs.out
    kids = () if bufs.kids is None else (bufs.kids.data_ptr(), kid_blocks)
    general = model_bits(config) != 0
    with span("pst.mobility.launch"), span_if(general, "pst.mobility.general"):
        lib.call(
            "pst_staged_phase_open" if kids else "pst_staged_phase",
            state.pos.data_ptr(), state.vel.data_ptr(), state.acc.data_ptr(),
            state.status.data_ptr(), state.id_hi.data_ptr(),
            state.id_lo.data_ptr(), state.n,
            out.pos.data_ptr(), out.vel.data_ptr(), out.acc.data_ptr(),
            out.status.data_ptr(), out.id_hi.data_ptr(), out.id_lo.data_ptr(),
            state.capacity, bufs.stacks.data_ptr(), bufs.stage.data_ptr(),
            bufs.list.data_ptr(), bufs.lookback.data_ptr(),
            (bufs.lookback.shape[1] - REGION_HEADER)
            // (config.spawn_depth + 1),
            bufs.result.data_ptr(), table.data_ptr(),
            *phys_args(config, poisson_step, t_steps), *kids,
            torch.cuda.current_stream(state.device).cuda_stream,
        )
    staged_phase.launches += 1
    staged_phase.open_launches += bool(kids)
    staged_phase.general_launches += general


staged_phase.launches = 0
staged_phase.open_launches = 0  # of them, launches of the open instantiation
# of them, launches of the general instantiation, compiled or open
staged_phase.general_launches = 0
staged_phase.passes = 0    # passes the kernel counted, over every phase
staged_phase.reclaims = 0  # reclaims the kernel made, over every phase
staged_phase.last = {}     # the last phase's STAGED_RESULT words


def run_staged_phase(state: SimState, bufs: StagedBuffers, poisson_step: int,
                     table, config: SimConfig, t_steps: int):
    """One phase of a CUDA state with ``state.n_clamped > 0`` into
    ``bufs`` (``staged_buffers``: sized with ``kid_blocks``, they run the
    open instantiation, else the compiled one), then the one readback of the
    result words: ``mobility_phase_dynamic``'s (state, info).  Raises
    where the phase did not converge."""
    from . import build

    staged_phase(build.load(), state, bufs, table, config, poisson_step,
                 t_steps)
    with span("pst.mobility.readback"):
        # the one readback
        r = dict(zip(STAGED_RESULT, bufs.result.tolist()))
    staged_phase.passes += r["passes"]
    staged_phase.reclaims += r["reclaims"]
    staged_phase.last = r
    if r["stuck"]:
        raise _not_converged(t_steps)
    return bufs.out._replace(n=r["n_live"]), _phase_info(
        state.n_clamped, r["n"], state.capacity, r["n_live"],
        r["reclaimed"], r["pushes"], r["passes"])


def _mobility_phase_dynamic_cuda(state: SimState, poisson_step: int, table,
                                 config: SimConfig, t_steps: int):
    _staged_checks(state, t_steps)
    check_kernel_args(config, table, state.device)
    if state.n_clamped == 0:
        return SimState(*(torch.zeros_like(t) for t in state[:6]), n=0), \
            _phase_info(0, state.n, state.capacity, 0, 0, 0, 0)
    kid_blocks = (0 if compiled(config)
                  else open_blocks("staged", config, state.device))
    with span("pst.mobility.alloc"):
        bufs = staged_buffers(state, config, kid_blocks)
    return run_staged_phase(state, bufs, poisson_step, table, config,
                            t_steps)


def mobility_phase_dynamic(state: SimState, poisson_step: int, table,
                           config: SimConfig, t_steps: int):
    """Work-list fixed point over staged passes; returns the compacted
    state and info (added, removed, overflow, reclaimed, passes, pushes_lo,
    pushes_hi).  A CPU state takes the plain version; a CUDA state
    launches the kernel or raises.  A float64 state raises first."""
    check_f32(state, "staged")
    if state.device.type == "cpu":
        return mobility_phase_dynamic_plain(
            state, poisson_step, table, config, t_steps
        )
    if state.device.type != "cuda":
        raise ValueError(f"no staged engine for device {state.device}")
    return _mobility_phase_dynamic_cuda(
        state, poisson_step, table, config, t_steps
    )


mobility_phase_dynamic.self_compacting = True
mobility_phase_dynamic_plain.self_compacting = True
