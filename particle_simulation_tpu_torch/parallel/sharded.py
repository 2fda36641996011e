"""Particles sharded over ranks of ``torch.distributed`` (counterpart of
``particle_simulation_tpu/parallel/sharded.py``).

The JAX package runs one program over a 1-D device mesh; here each rank is
a process of its own (``parallel/launch.py`` starts them), with one card
under NCCL, or a CPU (or a share of one card) under gloo.  The design is
the JAX package's:

* each rank owns ``config.capacity`` slots and its own ``n``; spawn, append
  and compaction are rank-local, so the mobility phase needs no
  communication (``ops.step.mobility_step`` runs the scheduler's engine,
  the CUDA kernels on a card);
* the field phase is position-indexed, so particles never migrate: under
  ``grid_mode="replicated"`` each rank deposits its live particles on the
  full grid, one int32 ``all_reduce`` sums the grids and every rank
  gathers its own field (the packed-diff gather, or the FFT model);
  ``bbox_subgrid`` is ignored there, as in JAX;
* under ``grid_mode="slab"`` the global bbox comes from int32 all-reduces
  MIN and MAX; when it fits the S^3 window, each rank deposits on the
  subgrid, a ``reduce_scatter`` leaves it one x-slab of S/d summed planes,
  one plane is exchanged with each neighbour (zeros at the edge ranks,
  the reference's missing neighbours), the stencil runs on the slab and
  an ``all_gather`` of its float32 rows gives every rank the subgrid's
  field; else the replicated path runs.  Both give the same bits;
* the ids are keyed by the global particle index (rank i seeds global
  particles [i * init_n, (i + 1) * init_n)), so a global workload gives
  the same sorted final multiset at any number of ranks.

Every branch a rank takes (slab or replicated, a live population or none)
reads an all-reduced value, so all ranks take it together; a rank whose
own population is empty still joins every collective.  The metrics of a
step are global: n, added and removed summed, overflow any rank's, the
pushes an exact int64 sum.  The JAX runtime's capacity ladder, chunking
and row checkpoint are not ported (they exist for XLA's static shapes and
the TPU worker fault): ``chunk_steps``, ``w_start`` and ``bucket_floor``
are accepted without effect.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import cross_section, interop
from ..config import SimConfig, check_supported
from ..device import resolve
from ..models.poisson_fft import gather_acceleration_fft
from ..ops import grid as grid_ops
from ..ops import population
from ..ops.step import mobility_step
from ..runtime import RunData, StepMetrics
from ..state import SimState, setup_particles, zero_state

DEFAULT_TIMEOUT_S = 60.0

# The collectives that gloo refuses on CUDA tensors: probes/gloo_cuda.py
# on the H100 with torch 2.11 found all_reduce, reduce_scatter and
# all_gather accepted and point-to-point sends refused.  On ranks that
# share a card over gloo these run on host copies, by design.
GLOO_CUDA_REFUSED = frozenset({"halo"})

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def _single(name: str, older: str):
    """``torch.distributed``'s single-tensor collective ``name``, or its
    older name in a torch that predates it (the same signature)."""
    return getattr(dist, name, None) or getattr(dist, older)


@dataclasses.dataclass
class Mesh:
    """One rank's view of the process group, and its collectives.

    ``stats`` counts each collective by tag: [calls, bytes, ms], the ms
    only while ``timed`` is set (each collective then waits for the device
    before and after it).  ``host_staged`` names the collectives that run
    on host copies (gloo on CUDA tensors: ``GLOO_CUDA_REFUSED``);
    ``host_copies`` counts the calls that did."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    host_staged: frozenset = frozenset()
    timed: bool = False
    stats: Dict[str, list] = dataclasses.field(default_factory=dict)
    host_copies: int = 0

    def reset_stats(self) -> None:
        self.stats = {}
        self.host_copies = 0

    @contextlib.contextmanager
    def _record(self, tag: str, nbytes: int):
        entry = self.stats.setdefault(tag, [0, 0, 0.0])
        entry[0] += 1
        entry[1] += nbytes
        if not self.timed:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        entry[2] += (time.perf_counter() - t0) * 1e3

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _staged(self, name: str) -> bool:
        if name in self.host_staged:
            self.host_copies += 1
            return True
        return False

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   tag: str = "") -> torch.Tensor:
        """``t`` reduced over the ranks, in place; returns ``t``."""
        with self._record(tag or f"all_reduce_{op}",
                          t.numel() * t.element_size()):
            x = t.cpu() if self._staged("all_reduce") else t
            dist.all_reduce(x, op=_OPS[op], group=self.group)
            if x is not t:
                t.copy_(x)
        return t

    def reduce_scatter(self, t: torch.Tensor, tag: str = "") -> torch.Tensor:
        """Sum of ``t`` (d*k, ...) over the ranks; this rank's block of k
        rows."""
        k = t.shape[0] // self.size
        with self._record(tag or "reduce_scatter",
                          t.numel() * t.element_size()):
            x = t.cpu() if self._staged("reduce_scatter") else t
            out = x.new_empty((k,) + tuple(t.shape[1:]))
            _single("reduce_scatter_single", "reduce_scatter_tensor")(
                out, x.contiguous(), group=self.group)
        return out.to(t.device)

    def all_gather(self, t: torch.Tensor, tag: str = "") -> torch.Tensor:
        """Every rank's ``t`` (k, ...) stacked in rank order: (d*k, ...)."""
        with self._record(tag or "all_gather",
                          t.numel() * t.element_size() * self.size):
            x = t.cpu() if self._staged("all_gather") else t
            out = x.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
            _single("all_gather_single", "all_gather_into_tensor")(
                out, x.contiguous(), group=self.group)
        return out.to(t.device)

    def halo(self, first: torch.Tensor, last: torch.Tensor,
             tag: str = "halo") -> Tuple[torch.Tensor, torch.Tensor]:
        """Send ``last`` to the next rank and ``first`` to the previous one;
        returns (the previous rank's last, the next rank's first), zeros
        where there is no such rank."""
        device = first.device
        with self._record(tag, 2 * first.numel() * first.element_size()):
            if self.size > 1 and self._staged("halo"):
                first, last = first.cpu(), last.cpu()
            first, last = first.contiguous(), last.contiguous()
            below, above = torch.zeros_like(last), torch.zeros_like(first)
            ops = []
            if self.rank + 1 < self.size:
                ops += [dist.P2POp(dist.isend, last, self.rank + 1,
                                   self.group),
                        dist.P2POp(dist.irecv, above, self.rank + 1,
                                   self.group)]
            if self.rank > 0:
                ops += [dist.P2POp(dist.isend, first, self.rank - 1,
                                   self.group),
                        dist.P2POp(dist.irecv, below, self.rank - 1,
                                   self.group)]
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        return below.to(device), above.to(device)

    def gather_object(self, obj) -> Optional[list]:
        """Every rank's ``obj`` on rank 0, in rank order; None elsewhere."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out


def make_mesh(n: int, device=None, backend: Optional[str] = None, *,
              rank: Optional[int] = None, init_method: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This process's rank of an ``n``-rank group, initialising the default
    group (``init_method``, ``rank``, a ``timeout_s`` on every collective)
    unless it exists.

    ``device`` is the card when None (device.resolve).  ``backend`` None is
    NCCL on a card, each rank on its own (``cuda:rank``), and gloo on the
    CPU; ``backend="gloo"`` on a card puts every rank on the one card named
    (ranks that share it), its refused collectives on host copies."""
    device = resolve(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs CUDA ranks; gloo runs CPU ranks")
    if not dist.is_initialized():
        if rank is None or init_method is None:
            raise ValueError("make_mesh needs rank and init_method to "
                             "initialise the process group")
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=init_method, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    size, rank = dist.get_world_size(), dist.get_rank()
    if size != n:
        raise ValueError(f"the process group has {size} ranks, not {n}")
    staged = frozenset()
    if device.type == "cuda":
        if backend == "nccl":
            if rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {rank} has no card of its own: "
                    f"{torch.cuda.device_count()} visible")
            device = torch.device("cuda", rank)
        else:
            device = torch.device("cuda", device.index or 0)
            staged = GLOO_CUDA_REFUSED
        torch.cuda.set_device(device)
    return Mesh(dist.group.WORLD, rank, size, device, backend, staged)


def setup_sharded(config: SimConfig, mesh: Mesh) -> SimState:
    """This rank's initial population: ``config.init_n`` and
    ``config.capacity`` are per rank, and rank i seeds the global particle
    indices [i * init_n, (i + 1) * init_n)."""
    return setup_particles(config, slot_offset=mesh.rank * config.init_n,
                           device=mesh.device)


def use_slab(config: SimConfig, n_ranks: int) -> bool:
    """Whether the field phase runs on x-slabs; a slab config that cannot
    raises ValueError (JAX sharded.py:179-189)."""
    S = config.bbox_subgrid
    ok = (config.grid_mode == "slab" and S > 0 and S % max(n_ranks, 1) == 0
          and config.field_model == "neighbour"
          and config.precision != "f64")
    if config.grid_mode == "slab" and not ok:
        raise ValueError(
            "grid_mode='slab' needs bbox_subgrid % n_ranks == 0, the "
            "neighbour field model and f32 precision")
    return ok


def _replicated_field(pos, weight, config: SimConfig, mesh: Mesh, path: str):
    """The full-grid deposit summed over the ranks, then the configured
    field model at this rank's particles, in the JAX package's order
    (``field_acceleration``): the FFT model, the float64 gather under
    ``precision="f64"``, else the packed diffs."""
    grid_ops.field_counts.note(path)
    charge = grid_ops.deposit(pos, weight, config.cell_size, config.grid_size)
    mesh.all_reduce(charge, tag="charge")
    if config.field_model == "fft":
        return gather_acceleration_fft(charge, pos, weight, config.cell_size,
                                       config.grid_size)
    if pos.dtype == torch.float64:
        return grid_ops.gather_acceleration(
            charge, pos, weight, config.cell_size, config.grid_size,
            config.electric_force_constant)
    return grid_ops.gather_acceleration_packdiff(
        charge, pos, weight, config.cell_size, config.grid_size,
        config.electric_force_constant)


def _slab_field(idx, weight, origin, config: SimConfig, mesh: Mesh):
    """The field on the S^3 subgrid at ``origin``, decomposed in x-slabs of
    S/d planes (JAX ``_slab_subgrid_field``)."""
    S = config.bbox_subgrid
    sx = S // mesh.size
    flat = grid_ops.subgrid_ids(idx, weight, origin, S)
    counts = grid_ops.subgrid_deposit(flat, S).view(S, S * S)
    slab = mesh.reduce_scatter(counts)  # (sx, S*S), summed
    below, above = mesh.halo(slab[0], slab[-1])
    ext = torch.cat([below[None], slab, above[None]]).view(sx + 2, S, S)
    mid = ext[1:-1]
    dx = ext[2:] - ext[:-2]
    dy = grid_ops.axis_diff(mid, 1)
    dz = grid_ops.axis_diff(mid, 2)
    e = torch.tensor(np.float32(config.electric_force_constant),
                     device=idx.device)
    rows = (torch.stack([dx, dy, dz], dim=-1).reshape(sx * S * S, 3)
            .to(torch.float32) * e)
    rows = mesh.all_gather(rows)  # (S^3, 3)
    acc = rows[flat.clamp(min=0).long()]
    return torch.where(weight[:, None] > 0, acc, torch.zeros_like(acc))


def sharded_grid_phase(state: SimState, config: SimConfig, mesh: Mesh,
                       slab: bool) -> SimState:
    """The field phase over every rank's particles; stores this rank's
    frozen acceleration.  ``grid_ops.field_counts`` records the path:
    ``full``, ``fft`` or ``f64`` (replicated), ``slab``, or
    ``window_fallback``."""
    m = state.n_clamped
    pos = state.pos[:m]
    weight = population.is_live(state.status[:m]).to(torch.int32)
    a = None
    path = ("fft" if config.field_model == "fft" else
            "f64" if pos.dtype == torch.float64 else "full")
    if slab:
        idx = grid_ops.cell_indices(pos, config.cell_size, config.grid_size)
        lo, hi = grid_ops.live_bbox(idx, weight, config.grid_size)
        mesh.all_reduce(lo, "min", tag="bbox")
        mesh.all_reduce(hi, "max", tag="bbox")
        origin, fits = grid_ops.fit_window(lo, hi, config.grid_size,
                                           config.bbox_subgrid)
        if fits:
            grid_ops.field_counts.note("slab")
            a = _slab_field(idx, weight, origin, config, mesh)
        else:
            path = "window_fallback"
    if a is None:
        a = _replicated_field(pos, weight, config, mesh, path)
    acc = torch.zeros_like(state.acc)
    acc[:m] = a
    return state._replace(acc=acc)


def _global_metrics(m: Dict, mesh: Mesh) -> Dict:
    """A rank's step metrics summed over the ranks (one int64 all-reduce):
    n, added, removed, overflow (any rank's) and the exact pushes."""
    local = torch.tensor(
        [m["n"], m["added"], m["removed"], int(m["overflow"]),
         m["pushes_lo"] + (m["pushes_hi"] << 30)],
        dtype=torch.int64, device=mesh.device)
    n, added, removed, overflow, pushes = mesh.all_reduce(
        local, tag="metrics").tolist()
    return {"n": n, "added": added, "removed": removed,
            "overflow": overflow > 0, "pushes": pushes}


def global_n(state: SimState, mesh: Mesh) -> int:
    t = torch.tensor([state.n], dtype=torch.int64, device=mesh.device)
    return int(mesh.all_reduce(t, tag="n").item())


def sharded_poisson_step(mesh: Mesh, config: SimConfig):
    """The multi-rank Poisson step: step(state, poisson_index, table) ->
    (this rank's compacted state, the global metrics).  Rejects a slab
    config that cannot run (``use_slab``)."""
    check_supported(config)
    slab = use_slab(config, mesh.size)

    def step(state: SimState, poisson_index: int, table: torch.Tensor):
        state = sharded_grid_phase(state, config, mesh, slab)
        state, m = mobility_step(state, poisson_index, table, config)
        return state, _global_metrics(m, mesh)

    return step


METRIC_KEYS = ("n", "added", "removed", "overflow", "pushes", "wall_s")


def sharded_poisson_loop(state: SimState, table, config: SimConfig,
                         mesh: Mesh, num_steps: int, first_index: int = 0
                         ) -> Tuple[SimState, Dict[str, List]]:
    """``num_steps`` sharded steps; metrics are per-step lists of the
    global values and of each step's host seconds (``wall_s``: the metrics'
    readback ends the step).  Once the global population is 0 the
    remaining steps are no-ops with zero metrics
    (``ops.step.poisson_loop``)."""
    step = sharded_poisson_step(mesh, config)
    metrics: Dict[str, List] = {k: [] for k in METRIC_KEYS}
    n = global_n(state, mesh)
    for i in range(num_steps):
        t0 = time.perf_counter()
        if n > 0:
            state, m = step(state, first_index + i, table)
            n = m["n"]
        else:
            m = dict.fromkeys(METRIC_KEYS, 0)
            m["overflow"] = False
        m["wall_s"] = time.perf_counter() - t0
        for k in METRIC_KEYS:
            metrics[k].append(m[k])
    return state, metrics


def run_pic_sharded_device(config: SimConfig, mesh: Mesh, table=None,
                           chunk_steps: int = 2, w_start: int = 0,
                           bucket_floor: int = 1 << 16,
                           initial_state: Optional[SimState] = None
                           ) -> RunData:
    """The multi-rank run_pic: returns ``runtime.RunData`` with the global
    counters, this rank's final state and the per-rank ``config``.  The run
    starts from ``initial_state`` (this rank's), else ``setup_sharded``,
    and its steps end with the one whose global population is 0, as
    ``run_pic``'s do (the JAX runtime's chunks of ``chunk_steps`` end with
    no-op rows instead)."""
    del chunk_steps, w_start, bucket_floor
    if table is None:
        table = cross_section.load_table(config.cross_section_path,
                                         mesh.device)
    state = (setup_sharded(config, mesh) if initial_state is None
             else initial_state)
    state, m = sharded_poisson_loop(state, table, config, mesh,
                                    config.poisson_steps)
    ns = m["n"]
    rows = ns.index(0) + 1 if 0 in ns else len(ns)
    steps = [StepMetrics(step=t, n=ns[t], added=m["added"][t],
                         removed=m["removed"][t], wall_s=m["wall_s"][t],
                         overflow=m["overflow"][t], pushes=m["pushes"][t])
             for t in range(rows)]
    return RunData(
        config=config,
        final_n=steps[-1].n if steps else global_n(state, mesh),
        total_added=sum(s.added for s in steps),
        total_removed=sum(s.removed for s in steps),
        device_time_ms=sum(s.wall_s for s in steps) * 1e3, state=state,
        steps=steps)


def history_of(run: RunData) -> List[Dict]:
    """The per-step history of the JAX ``run_pic_sharded``."""
    return [{"n": s.n, "added": s.added, "removed": s.removed,
             "overflow": int(s.overflow), "pushes": int(s.pushes)}
            for s in run.steps]


def run_pic_sharded(config: SimConfig, mesh: Mesh, table=None, **kwargs):
    """The JAX package's compat surface: (this rank's state, history)."""
    run = run_pic_sharded_device(config, mesh, table, **kwargs)
    return run.state, history_of(run)


def gather_live(state: SimState, mesh: Mesh) -> Optional[dict]:
    """Every rank's live rows, ids included, on rank 0 as numpy arrays in
    the JAX SimState's types (rank order); None on the other ranks."""
    live = population.is_live(state.status[:state.n_clamped])
    rows = interop.state_to_numpy(SimState(
        *(x[:state.n_clamped][live] for x in state[:6]), n=0))
    del rows["n"]
    parts = mesh.gather_object(rows)
    if parts is None:
        return None
    return {k: np.concatenate([p[k] for p in parts]) for k in rows}


def kernel_counters():
    """The launch counters of the kernels a rank can reach, by name."""
    from ..ops.kernels.field import packed_field_gather
    from ..ops.kernels.push_mcc import staged_phase
    from ..ops.kernels.worklog import worklog_phase

    return {"worklog_phase": worklog_phase, "staged_phase": staged_phase,
            "packed_field_gather": packed_field_gather}


def run_scenarios(mesh: Mesh, scenarios: List[dict]) -> List[dict]:
    """The rank function of ``launch.run`` for checks and the CLI: one
    ``run_pic_sharded_device`` per scenario, a dict with ``config`` (per
    rank) and optionally ``gather`` (the live rows to rank 0, default
    True), ``timed`` (time the collectives) and ``empty_ranks`` (ranks
    that start with no particle).  Returns per scenario the
    history, the rank's kernel launches, field paths, step ms and
    collective stats, and on rank 0 the live rows; and the modules of JAX
    this process has loaded (none, by the port's contract)."""
    out = []
    kernels = kernel_counters()
    for sc in scenarios:
        config = sc["config"]
        for k in kernels.values():
            k.launches = 0
        grid_ops.field_counts.reset()
        mesh.reset_stats()
        mesh.timed = bool(sc.get("timed", False))
        start = (zero_state(config, mesh.device)
                 if mesh.rank in sc.get("empty_ranks", ()) else None)
        run = run_pic_sharded_device(config, mesh, initial_state=start)
        mesh.timed = False
        res = {
            "rank": mesh.rank,
            "history": history_of(run),
            "final_n": run.final_n,
            "n_local": run.state.n,
            "step_ms": [s.wall_s * 1e3 for s in run.steps],
            "launches": {name: k.launches for name, k in kernels.items()},
            "field_paths": grid_ops.field_counts.as_dict(),
            "comm": {k: list(v) for k, v in mesh.stats.items()},
            "host_copies": mesh.host_copies,
            "host_staged": sorted(mesh.host_staged),
            "device": str(mesh.device),
            "backend": mesh.backend,
        }
        if sc.get("gather", True):
            res["live"] = gather_live(run.state, mesh)
        out.append(res)
    foreign = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.")
                     or m == "particle_simulation_tpu"
                     or m.startswith("particle_simulation_tpu."))
    for res in out:
        res["foreign_modules"] = foreign
    return out
