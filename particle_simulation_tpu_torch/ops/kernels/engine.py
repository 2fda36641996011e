"""The host side of the two fused mobility engines, and the contract
their kernels share: the work-log engine (scheduler ``dynamic``,
``worklog.py``, ``csrc/worklog.cu``) and the staged engine
(``dynamic_old``, ``push_mcc.py``, ``csrc/staged.cu``).

Each engine module describes its engine once, as an ``Engine`` record: its
C symbols, its scratch layout and the arguments that pass it, its result
words and how they become the phase's (state, info), its own checks and
its plain version.  ``Phase`` is what a phase does on the host, written
once for both: the buffers, the check before the launch, the one launch
of the phase with its spans and counters, the one readback of the result
words, the shortcut for an empty state, the choice between the compiled
and the open instantiation, and the dispatch by device (a CPU state to
the plain version, a CUDA state to the kernel, any other device raises).

A phase keeps its output states between launches (``KeptOutputs``, two a
device and stream, used in turn).  A kept output carries a mark, the rows
its last phase wrote: every row past it holds zeros, so the kernel clears
only the rows between the new population and the mark (``clear_to``),
where a fresh output costs a clear of the whole capacity.  The scratch is
not kept: the caching allocator serves it again each phase, and a kept
scratch would stay allocated through the field phase, whose own peak is
the larger where the box does not fit the subgrid (the magnetized cell).
The phase takes a kept output only where nothing outside the engine holds
its storage and no torch in-place write has reached it since it was handed
out (its version counters): a caller that keeps its states or writes them
in place gets a fresh output, or a clear of the whole capacity, as before.

The model menu (integrator, b_field, collision_model, boundary) reaches
both kernels through ``phys_args``: the ``MODEL_BITS`` of the selection and
the boris rotation's constants.  Model 0, the reference, launches the
instantiations of the main path; any other the general ones
(csrc/physics.cuh).  The plain versions call ``update_particles`` with the
same selection (``physics.model_args``).

Records travel as (12, C) int32 stacks in ``FIELD_NAMES`` order, float
fields as bit patterns.  Both kernels are compiled for spawn depths
1..``MAX_DEPTH`` and the Threefry round counts ``ROUNDS`` (``compiled``),
the children in registers; every other (depth, rounds) runs their open
instantiation, which reads both at run time and keeps a lane's children in
a scratch buffer sized by the resident grid (``open_blocks``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from ... import rng
from ...config import SimConfig, f32_only
from ...cross_section import BUCKET_SCALE, LOG10_E, N_STEPS
from ...state import SimState
from ...utils.profiling import span, span_if
from ..physics import half, rotation, scalar

FIELD_NAMES = (
    "px", "py", "pz", "vx", "vy", "vz", "ax", "ay", "az",
    "status", "id_hi", "id_lo",
)
NF = len(FIELD_NAMES)

MAX_DEPTH = 4        # spawn depths 1..MAX_DEPTH are compiled instantiations
ROUNDS = (13, 20)    # and so are these Threefry round counts
CHILD_WORDS = 9      # a Child of csrc/physics.cuh: 6 floats, stamp, id words

PUSH_BASE = 1 << 30


def pushes_info(total: int) -> dict:
    """An exact push count as the base-2^30 pair of the JAX package."""
    return {"pushes_lo": total % PUSH_BASE, "pushes_hi": total // PUSH_BASE}


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
PHYS_MODEL = 13  # where ``phys_args`` puts the model bits


def phys_args(config: SimConfig, poisson_step: int, t_steps: int) -> tuple:
    """The kernels' physics arguments: dt, half_dt, sim_size, log10_e,
    bucket_scale, seed, poisson_step, t_steps, spawn_depth, rounds,
    block2, the model bits (at ``PHYS_MODEL``) and the boris rotation's t
    and s (zeros without a field)."""
    sx, sy, sz = (scalar(s) for s in config.sim_size)
    boris = config.integrator == "boris"
    rot = rotation(config.b_field, config.mobility_dt) if boris else None
    bits = (MODEL_BITS["boris"] * boris
            | MODEL_BITS["magnetized"] * (rot is not None)
            | MODEL_BITS["isotropic"] * (config.collision_model == "isotropic")
            | MODEL_BITS["periodic"] * (config.boundary == "periodic"))
    t, s = rot or ((0.0,) * 3,) * 2
    return (
        scalar(config.mobility_dt), half(config.mobility_dt), sx, sy, sz,
        float(LOG10_E), float(BUCKET_SCALE),
        config.seed & rng.MASK, poisson_step & rng.MASK, t_steps,
        config.spawn_depth, config.rng_rounds,
        int(config.rng_mode == "block2"), bits, *t, *s,
    )


def model_bits(config: SimConfig) -> int:
    """The model selections of ``config`` as PhysConsts::model bits."""
    return phys_args(config, 0, 0)[PHYS_MODEL]


def empty_state(capacity: int, device) -> SimState:
    """An uninitialised state of ``capacity`` slots on ``device``, n = 0:
    the output a phase kernel writes."""
    vec3 = lambda: torch.empty((capacity, 3), dtype=torch.float32,
                               device=device)
    word = lambda: torch.empty((capacity,), dtype=torch.int32, device=device)
    return SimState(vec3(), vec3(), vec3(), word(), word(), word(), n=0)


def storage_refs(t: torch.Tensor) -> int:
    """The tensors that share ``t``'s storage: ``t`` itself, its views and
    its aliases (``detach``), whoever holds them."""
    # the storage object made here holds one reference of its own
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata) - 1


def versions(st: SimState) -> tuple:
    """The version counter of each of ``st``'s tensors, which torch bumps
    at every in-place write through any view or alias; None for an
    inference tensor, which keeps none."""
    out = []
    for t in st[:6]:
        try:
            out.append(t._version)
        except RuntimeError:
            out.append(None)
    return tuple(out)


@dataclasses.dataclass
class Kept:
    """An output state a phase keeps between launches: its own references
    to the tensors (a caller gets aliases of them, never these), the mark
    (every row at or past it holds zeros) and ``versions`` when the phase
    handed it out (None before)."""

    out: SimState
    mark: int
    versions: Optional[tuple] = None


def clear_to(kept: Kept, capacity: int, device) -> Optional[int]:
    """The rows of ``kept``'s output that a phase at ``capacity`` on
    ``device`` has to clear past its population: None where the phase may
    not take it (another capacity or device, or a tensor that anything
    outside the engine still holds: a caller's state, a view of it, the
    phase's own input), the capacity where a torch in-place write has
    reached it since it was handed out, else its mark."""
    out = kept.out
    if out.capacity != capacity or out.device != torch.device(device):
        return None
    if any(storage_refs(t) > 1 for t in out[:6]):
        return None
    now = versions(out)
    if now != kept.versions or None in now:
        return capacity
    return kept.mark


class KeptOutputs:
    """The output states one engine keeps for its phases on one device and
    stream: at most two (``Kept``, the least recently taken first), used
    in turn while a caller holds the last one."""

    def __init__(self):
        self.outs = []

    def take(self, state: SimState) -> Tuple[Kept, int]:
        """The output of one phase of ``state`` and its ``clear_to``: the
        kept output that needs the least clearing, else a fresh one
        (cleared to the capacity), which takes the place of the least
        recently taken where both are held elsewhere.  Outputs of another
        capacity or device are dropped."""
        c, dev = state.capacity, state.device
        self.outs = [k for k in self.outs
                     if k.out.capacity == c and k.out.device == dev]
        choices = [(to, i) for i, k in enumerate(self.outs)
                   if (to := clear_to(k, c, dev)) is not None]
        if choices:
            to, i = min(choices)
            kept = self.outs.pop(i)
        else:
            to, kept = c, Kept(empty_state(c, dev), c)
            if len(self.outs) == 2:
                self.outs.pop(0)
        self.outs.append(kept)
        return kept, to


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


def not_converged(label: str, t_steps: int) -> RuntimeError:
    return RuntimeError(
        f"{label} engine did not converge in {t_steps + 1} passes")


def _no_check(state: SimState, t_steps: int) -> None:
    pass


@dataclasses.dataclass(frozen=True)
class Engine:
    """What tells one fused engine from the other on the host."""

    # the stem of the C symbols: pst_<name>_phase, its _open twin and
    # pst_<name>_open_blocks
    name: str
    label: str   # the engine in messages ("work-log", "staged")
    tile: int    # threads a block: the children scratch holds blocks * tile
    # the NamedTuple of the phase's buffers: ``out``, the scratch, ``kids``
    buffers: type
    # (config, capacity, kid_blocks) -> {name: (shape, dtype)} of the
    # scratch, ``result`` among it, ``kids`` where kid_blocks > 0
    scratch: Callable[[SimConfig, int, int], dict]
    # (buffers, config) -> the scratch's arguments before ``result``, in
    # the order of the C ABI
    scratch_args: Callable[..., tuple]
    n0: Callable[[SimState], int]  # the records the launch takes as n0
    result: Tuple[str, ...]        # the words the kernel leaves in result
    # (state, out, result words) -> the phase's (state, info)
    finish: Callable[..., tuple]
    plain: Callable[..., tuple]    # the plain version, the phase's protocol
    # (state, t_steps) -> raise for what this engine alone does not take
    check: Callable[[SimState, int], None] = _no_check
    # result words summed, over every phase, into the launcher's counters
    counters: Tuple[str, ...] = ("passes",)


class Phase:
    """One engine's mobility phase on the host.  Called as
    ``(lib, state, bufs, table, config, poisson_step, t_steps)`` it is the
    launch; it carries the counters ``launches``, ``open_launches``,
    ``general_launches`` and ``out_reuses`` (of the launches, those of the
    open and of the general instantiation, and those on a kept output
    cleared to less than the capacity), one per word of
    ``engine.counters`` (summed over every phase) and ``last``, the last
    phase's result words."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.launches = self.open_launches = self.general_launches = 0
        self.out_reuses = 0
        for word in engine.counters:
            setattr(self, word, 0)
        self.last = {}
        # (device, stream) -> KeptOutputs; an entry is out of the dict
        # while its phase runs, so two callers never share one
        self.kept = {}

    def buffers(self, state: SimState, config: SimConfig,
                kid_blocks: int = 0, out: Optional[SimState] = None):
        """Uninitialised buffers for one phase on the state's device (the
        kernel writes or zeroes what it reads) around ``out``, a fresh
        output state when None; with ``kid_blocks``, for the open
        instantiation on a grid of that many blocks."""
        dev, c = state.device, state.capacity
        return self.engine.buffers(
            empty_state(c, dev) if out is None else out, **{
                name: torch.empty(shape, dtype=dtype, device=dev)
                for name, (shape, dtype)
                in self.engine.scratch(config, c, kid_blocks).items()
            })

    def __call__(self, lib, state: SimState, bufs, table, config: SimConfig,
                 poisson_step: int, t_steps: int,
                 clear_to: Optional[int] = None) -> None:
        """Launch one whole mobility phase on the current stream: the
        records of ``state`` (read, never written) through every pass to
        the compacted output ``bufs.out``, whose rows from ``clear_to``
        on hold zeros (None: the capacity, any content); ``bufs.result``
        receives the ``engine.result`` words.  With ``bufs.kids`` the open
        instantiation runs (on as many blocks as the scratch was sized
        for), else the compiled one; any model but the reference launches
        the general instantiation, inside the span
        ``pst.mobility.general``.  Raises before any launch on a buffer the
        kernel does not take."""
        e, c, out = self.engine, state.capacity, bufs.out
        clear_to = c if clear_to is None else clear_to
        kid_blocks = 0 if bufs.kids is None else bufs.kids.shape[1] // e.tile
        check_buffers(f"{e.label} phase", state.device, [
            *state_buffers("state", state, c), *state_buffers("out", out, c),
            *((name, getattr(bufs, name), dtype, shape)
              for name, (shape, dtype)
              in e.scratch(config, c, kid_blocks).items()),
        ])
        kids = () if bufs.kids is None else (bufs.kids.data_ptr(), kid_blocks)
        phys = phys_args(config, poisson_step, t_steps)
        general = phys[PHYS_MODEL] != 0
        with span("pst.mobility.launch"), span_if(general,
                                                  "pst.mobility.general"):
            lib.call(
                f"pst_{e.name}_phase_open" if kids else f"pst_{e.name}_phase",
                *(t.data_ptr() for t in state[:6]), e.n0(state),
                *(t.data_ptr() for t in out[:6]), c, clear_to,
                *e.scratch_args(bufs, config), bufs.result.data_ptr(),
                table.data_ptr(), *phys, *kids,
                torch.cuda.current_stream(state.device).cuda_stream,
            )
        self.launches += 1
        self.open_launches += bool(kids)
        self.general_launches += general
        self.out_reuses += clear_to < c

    def run(self, state: SimState, bufs, poisson_step: int, table,
            config: SimConfig, t_steps: int,
            clear_to: Optional[int] = None):
        """One phase of a CUDA state with ``state.n_clamped > 0`` into
        ``bufs`` (``buffers``: sized with ``kid_blocks``, they run the open
        instantiation, else the compiled one; ``clear_to`` as the launch
        takes it), then the one readback of the result words: the phase's
        (state, info).  Raises where the phase did not converge."""
        from . import build

        e = self.engine
        self(build.load(), state, bufs, table, config, poisson_step, t_steps,
             clear_to)
        with span("pst.mobility.readback"):
            r = dict(zip(e.result, bufs.result.tolist()))  # the one readback
        for word in e.counters:
            setattr(self, word, getattr(self, word) + r[word])
        self.last = r
        if r["stuck"]:
            raise not_converged(e.label, t_steps)
        return e.finish(state, bufs.out, r)

    def mobility(self, state: SimState, poisson_step: int, table,
                 config: SimConfig, t_steps: int):
        """The mobility phase of ``state``: on the CPU the plain version,
        on CUDA the kernel (an empty state reads back zeros without a
        launch), on any other device a ValueError.  A float64 state raises
        first."""
        e = self.engine
        check_f32(state, e.label)
        if state.device.type == "cpu":
            return e.plain(state, poisson_step, table, config, t_steps)
        if state.device.type != "cuda":
            raise ValueError(f"no {e.label} engine for device {state.device}")
        e.check(state, t_steps)
        check_kernel_args(config, table, state.device)
        if state.n_clamped == 0:
            zeros = SimState(*(torch.zeros_like(t) for t in state[:6]), n=0)
            return e.finish(state, zeros, dict.fromkeys(e.result, 0))
        kid_blocks = (0 if compiled(config)
                      else open_blocks(e.name, config, state.device))
        return self.run_kept(state, poisson_step, table, config, t_steps,
                             kid_blocks)

    def run_kept(self, state: SimState, poisson_step: int, table,
                 config: SimConfig, t_steps: int, kid_blocks: int = 0):
        """``run`` on an output this phase keeps for the state's device and
        the current stream (``KeptOutputs.take``: a kept one where one is
        free, cleared to its ``clear_to``, else a fresh one) and fresh
        scratch; the output's new mark is the population it holds.  The caller gets
        aliases of the output's tensors, so the storage counts show the
        next phase whether it still holds them."""
        key = (state.device,
               torch.cuda.current_stream(state.device).cuda_stream)
        with span("pst.mobility.alloc"):
            kept = self.kept.pop(key, None) or KeptOutputs()
            out, to = kept.take(state)
            bufs = self.buffers(state, config, kid_blocks, out.out)
        out.mark = state.capacity  # until the kernel has written it
        try:
            st, info = self.run(state, bufs, poisson_step, table, config,
                                t_steps, to)
            out.mark, out.versions = st.n, versions(out.out)
        finally:
            self.kept[key] = kept
        return st._replace(**{f: getattr(st, f).detach()
                              for f in SimState._fields[:6]}), info
