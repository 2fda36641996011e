"""Charge-grid operations: deposition, stencil, gather (counterpart of
``particle_simulation_tpu/ops/grid.py``).

Reference src/grid_operations.cu: each live particle adds +1 to its cell
(:15-26); the per-cell acceleration is (charge[+1] - charge[-1]) per axis
times Electric_Force_Constant, missing neighbours counting 0 (:29-56),
gathered at the particle's own cell (:59-72).

The field phase is the JAX package's: ``bbox_field_acceleration`` deposits,
builds the stencil and gathers on an S^3 subgrid around the live
population's bounding box, and falls back to the full grid when the box
does not fit the window.  The subgrid is worth as much here as on the TPU:
the live population sits in a ~62-cell cube, so the full 256^3 phase zeroes
and streams 67 MB grids for 1 MB of live cells.  Both paths pack the three
integer diffs into one 10-bit-per-field int32 grid and gather it once per
particle with ``kernels.field.packed_field_gather`` (the CUDA kernel on a
CUDA tensor); when some |diff| exceeds 511 they gather (cells, 3) float32
rows in plain torch instead.  Every path gives the same values,
``float32(int diff) * float32(e_const)``.  Under ``precision="f64"`` the
JAX package takes neither the subgrid nor the packed diffs: the full-grid
deposit and ``gather_acceleration``, whose diff is widened to float64,
multiplied by ``float64(e_const)`` and rounded once to float32.

Deposits are int32 ``index_add_``: integer atomics are exact, so the counts
do not depend on the order of the adds.  Each ``lax.cond`` of the JAX path
(the window test, the 10-bit test) is a host decision on a value read back
once; ``field_counts`` counts the decisions and the readbacks.  The parts
of a field phase are spans inside ``pst.field`` (``utils.profiling.span``):
``pst.field.window``, ``.window_readback``, ``.deposit``, ``.stencil``,
``.fits_readback``, ``.gather`` (and ``.store``, in ``ops.step``).

On a float32 CUDA state ``ops.step.grid_phase`` takes the subgrid as
``subgrid_field_chain`` instead: ``kernels.field``'s bbox kernel, the
window test on its six words read back once, the deposit kernel and a
kernel that gathers the three integer diffs at each live row and writes
the state's whole ``acc``; its spans are ``pst.field.window``,
``.window_readback``, ``.deposit`` and ``.gather``.  It shares only the
window test (``window_of``) with the chain above, and falls back to the
same full grid.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import field as field_kernels
from .kernels.field import PACK_BIAS as _PACK_BIAS
from .kernels.field import packed_field_gather
from ..utils.profiling import span


class FieldCounts:
    """What the field phases took since the last ``reset``: ``subgrid``,
    ``window_fallback`` (the box did not fit the window), ``full``
    (``bbox_subgrid=0``), ``fft`` (``field_model="fft"``) and ``f64``
    (``precision="f64"``: the float64 gather) per field phase, ``slab``
    per sharded field phase on x-slabs
    (``parallel.sharded``), ``rows_fallback`` per 10-bit
    misfit, ``readbacks`` per value read back to the host, ``last`` the
    path of the latest field phase."""

    PATHS = ("subgrid", "window_fallback", "full", "fft", "slab", "f64")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.paths = dict.fromkeys(self.PATHS, 0)
        self.rows_fallback = 0
        self.readbacks = 0
        self.last = ""

    def note(self, path: str) -> None:
        self.paths[path] += 1
        self.last = path

    def as_dict(self) -> dict:
        return {**self.paths, "rows_fallback": self.rows_fallback,
                "readbacks": self.readbacks}


field_counts = FieldCounts()


def cell_indices(pos: torch.Tensor, cell_size, grid_size) -> torch.Tensor:
    """Integer cell coordinates trunc(pos * (1 / cell_size)), the factor
    rounded to the positions' type, clamped into the grid; (N, 3) int32."""
    inv = 1.0 / cell_size
    if pos.dtype != torch.float64:
        inv = float(np.float32(inv))
    idx = (pos * inv).to(torch.int32)
    maxes = torch.tensor(grid_size, dtype=torch.int32, device=pos.device) - 1
    return torch.minimum(torch.clamp(idx, min=0), maxes)


def flatten_cells(ix, iy, iz, grid_size):
    gx, gy, gz = grid_size
    return (ix * gy + iy) * gz + iz


def deposit(pos, weight, cell_size, grid_size) -> torch.Tensor:
    """Histogram particle counts into a flat (gx*gy*gz,) int32 grid;
    ``weight`` is 1 for live particles and 0 otherwise."""
    gx, gy, gz = grid_size
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    charge = torch.zeros(gx * gy * gz, dtype=torch.int32, device=pos.device)
    return charge.index_add_(0, flat.long(), weight.to(torch.int32))


def axis_diff(c: torch.Tensor, axis: int) -> torch.Tensor:
    """c[+1] - c[-1] along ``axis`` of an int32 grid, missing neighbours
    0."""
    n = c.shape[axis]
    up = torch.zeros_like(c)
    down = torch.zeros_like(c)
    up.narrow(axis, 0, n - 1).copy_(c.narrow(axis, 1, n - 1))
    down.narrow(axis, 1, n - 1).copy_(c.narrow(axis, 0, n - 1))
    return up - down


def _int_diffs(charge_flat, grid_size):
    """The stencil as integer neighbour differences charge[+1] - charge[-1]
    per axis, missing neighbours 0: three int32 grids."""
    c = charge_flat.reshape(grid_size)
    return tuple(axis_diff(c, axis) for axis in range(3))


def gather_acceleration(charge_flat, pos, weight, cell_size, grid_size,
                        e_const) -> torch.Tensor:
    """(N, 3) float32 acceleration at each particle's cell, 0 where
    ``weight`` is 0: the full-grid reference, three gathers.  The diffs
    are scaled in the positions' type: float32, or under ``precision=
    "f64"`` float64 then rounded once to float32 (JAX grid.py
    ``gather_acceleration``)."""
    diffs = _int_diffs(charge_flat, grid_size)
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size).long()
    fdt = torch.float64 if pos.dtype == torch.float64 else torch.float32
    e = torch.tensor(e_const, dtype=fdt, device=pos.device)
    acc = torch.stack([d.reshape(-1)[flat].to(fdt) * e
                       for d in diffs], dim=1).to(torch.float32)
    return torch.where(weight[:, None] > 0, acc, torch.zeros_like(acc))


def _diff_field(dx, dy, dz, e_const) -> torch.Tensor:
    """The acceleration grid of three diff grids: (..., 3) float32,
    float32(diff) * float32(e_const)."""
    e = torch.tensor(np.float32(e_const), device=dx.device)
    return torch.stack([dx, dy, dz], dim=-1).to(torch.float32) * e


def field_grid(charge_flat, grid_size, e_const) -> torch.Tensor:
    """The full acceleration grid (gx, gy, gz, 3) float32, the reference's
    updateGrid output (the JAX package's tests and diagnostics read it)."""
    return _diff_field(*_int_diffs(charge_flat, grid_size), e_const)


def _gather_rows(rows, flat, weight) -> torch.Tensor:
    """(m, 3) rows of a (cells, 3) field at cells ``flat`` (-1 for a dead
    slot), 0 where ``weight`` is 0."""
    acc = rows[flat.clamp(min=0).long()]
    return torch.where(weight[:, None] > 0, acc, torch.zeros_like(acc))


def gather_acceleration_packed(charge_flat, pos, weight, cell_size,
                               grid_size, e_const) -> torch.Tensor:
    """The full-grid field as one (cells, 3) float32 row gather of
    ``field_grid``: the same values as ``gather_acceleration_packdiff``."""
    rows = field_grid(charge_flat, grid_size, e_const).reshape(-1, 3)
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    return _gather_rows(rows, flat, weight)


def pack_diffs(dx, dy, dz) -> torch.Tensor:
    """Three int32 diff grids with |diff| <= 511 -> one flat int32 grid of
    10-bit biased fields (dx in bits 20-29, dy 10-19, dz 0-9)."""
    return (((dx + _PACK_BIAS) << 20) | ((dy + _PACK_BIAS) << 10)
            | (dz + _PACK_BIAS)).reshape(-1)


def _field_from_diffs(dx, dy, dz, flat, weight, e_const) -> torch.Tensor:
    """(m, 3) float32 field at cells ``flat`` (-1 for a dead slot) of the
    diff grids, 0 where ``weight`` is 0: the packed gather when every
    |diff| fits 10 bits (one readback decides), else (cells, 3) rows."""
    with span("pst.field.fits_readback"):
        fits = bool(torch.stack([d.abs().amax() for d in (dx, dy, dz)])
                    .amax() <= _PACK_BIAS - 1)
    field_counts.readbacks += 1
    with span("pst.field.gather"):
        if fits:
            return packed_field_gather(pack_diffs(dx, dy, dz), flat, weight,
                                       e_const)
        field_counts.rows_fallback += 1
        return _gather_rows(_diff_field(dx, dy, dz, e_const).reshape(-1, 3),
                            flat, weight)


def gather_acceleration_packdiff(charge_flat, pos, weight, cell_size,
                                 grid_size, e_const) -> torch.Tensor:
    """The full-grid field: the packed diff grid gathered once per particle
    (rows of float32 when some |diff| > 511); int32 ``weight``."""
    with span("pst.field.stencil"):
        dx, dy, dz = _int_diffs(charge_flat, grid_size)
    idx = cell_indices(pos, cell_size, grid_size)
    flat = flatten_cells(idx[:, 0], idx[:, 1], idx[:, 2], grid_size)
    return _field_from_diffs(dx, dy, dz, flat, weight, e_const)


def live_bbox(idx, weight, grid_size):
    """(lo, hi) int32 (3,) cell-coordinate bounds over weighted particles.
    With no live particles lo > hi (lo=grid_size, hi=-1)."""
    live = weight[:, None] > 0
    big = torch.tensor(grid_size, dtype=torch.int32, device=idx.device)
    none = torch.full_like(big, -1)
    # a sentinel row each, so an empty population reduces too
    lo = torch.cat([torch.where(live, idx, big), big[None]]).amin(0)
    hi = torch.cat([torch.where(live, idx, none), none[None]]).amax(0)
    return lo, hi


def fit_window(lo, hi, grid_size, subgrid: int):
    """The window test of the bbox path on one readback of the bounds
    ``lo``, ``hi`` ((3,) int32 tensors, ``live_bbox``'s): (origin, fits),
    the JAX package's test, so that both take the same path.  Its margins
    (``origin = max(lo - 1, 0)``; extent S-2, or S-1 at the global edge)
    change no value: no live particle lies outside the box, so every cell
    outside it holds zero charge."""
    with span("pst.field.window_readback"):
        lo_hi = torch.cat([lo, hi]).tolist()
    field_counts.readbacks += 1
    return window_of(lo_hi[:3], lo_hi[3:], grid_size, subgrid)


def window_of(lo, hi, grid_size, subgrid: int):
    """(origin, fits) of host bounds ``lo``, ``hi`` (three ints each): the
    window test's arithmetic."""
    S = subgrid
    origin = [max(l - 1, 0) for l in lo]
    fits = all(
        (h - o <= S - 2) or (h - o <= S - 1 and h == g - 1)
        for o, h, g in zip(origin, hi, grid_size)
    )
    return origin, fits


def subgrid_ids(idx, weight, origin, subgrid: int) -> torch.Tensor:
    """Flat subgrid cell ids relative to ``origin``; -1 for a dead slot."""
    S = subgrid
    rel = idx - torch.tensor(origin, dtype=torch.int32, device=idx.device)
    flat = (rel[:, 0] * S + rel[:, 1]) * S + rel[:, 2]
    return torch.where(weight > 0, flat, torch.full_like(flat, -1))


def subgrid_deposit(flat_sub, subgrid: int) -> torch.Tensor:
    """Counts of the S^3 subgrid (the JAX ``_mxu_histogram``): an int32
    ``index_add_``.  Dead ids (-1) land in one spare cell past the grid,
    which is dropped: ``index_add_`` takes no negative index."""
    cells = subgrid ** 3
    counts = torch.zeros(cells + 1, dtype=torch.int32, device=flat_sub.device)
    ids = torch.where(flat_sub >= 0, flat_sub, torch.full_like(flat_sub, cells))
    counts.index_add_(0, ids.long(), torch.ones_like(ids))
    return counts[:cells]


def _subgrid_packdiff_acc(flat_sub, counts, S, e_const, weight):
    """Field values from subgrid counts: packed-diff build + one gather.
    Bit-identical to the full-grid packdiff path restricted to the bbox
    (missing neighbours are 0 either way)."""
    with span("pst.field.stencil"):
        dx, dy, dz = _int_diffs(counts, (S, S, S))
    return _field_from_diffs(dx, dy, dz, flat_sub, weight, e_const)


def _check_subgrid(S: int) -> None:
    if S <= 0 or (S * S * S) % 128:
        raise ValueError(f"subgrid edge {S} must be a positive multiple of 8")


def window_fallback_acceleration(pos, weight, cell_size, grid_size,
                                 e_const) -> torch.Tensor:
    """The field of a box that does not fit the window: the full grid's
    deposit and packed diffs, noted as ``window_fallback``."""
    field_counts.note("window_fallback")
    with span("pst.field.deposit"):
        charge = deposit(pos, weight, cell_size, grid_size)
    return gather_acceleration_packdiff(
        charge, pos, weight, cell_size, grid_size, e_const)


def bbox_field_acceleration(pos, weight, cell_size, grid_size, e_const,
                            subgrid: int = 64) -> torch.Tensor:
    """The field phase (deposit + stencil + gather) on an S^3 subgrid when
    the live population fits the window, else on the full grid; the same
    values either way.  ``weight`` is int32, 1 for a live particle."""
    S = subgrid
    _check_subgrid(S)
    with span("pst.field.window"):
        idx = cell_indices(pos, cell_size, grid_size)
        lo, hi = live_bbox(idx, weight, grid_size)
    origin, fits = fit_window(lo, hi, grid_size, S)
    if not fits:
        return window_fallback_acceleration(pos, weight, cell_size,
                                            grid_size, e_const)
    field_counts.note("subgrid")
    with span("pst.field.deposit"):
        flat_sub = subgrid_ids(idx, weight, origin, S)
        counts = subgrid_deposit(flat_sub, S)
    return _subgrid_packdiff_acc(flat_sub, counts, S, e_const, weight)


def subgrid_field_chain(pos, status, m, cell_size, grid_size, e_const,
                        subgrid: int):
    """The subgrid field phase of a float32 state on the card, as
    ``kernels.field``'s chain: the new (capacity, 3) ``acc`` of the state
    whose ``pos`` (capacity, 3) and ``status`` (capacity,) hold its
    population in the first ``m`` rows, or None when the box does not fit
    the window (the caller then takes the full grid).  The same values as
    ``bbox_field_acceleration`` stored at capacity, with one readback (the
    window test) and the three kernels; CPU tensors take their plain
    twins."""
    S = subgrid
    _check_subgrid(S)
    with span("pst.field.window"):
        words = field_kernels.subgrid_bbox(pos, status, m, cell_size,
                                           grid_size)
    with span("pst.field.window_readback"):
        lo, hi = field_kernels.bbox_bounds(words.tolist(), grid_size)
    field_counts.readbacks += 1
    origin, fits = window_of(lo, hi, grid_size, S)
    if not fits:
        return None
    field_counts.note("subgrid")
    with span("pst.field.deposit"):
        counts = field_kernels.subgrid_deposit(pos, status, m, cell_size,
                                               grid_size, origin, S)
    with span("pst.field.gather"):
        return field_kernels.subgrid_field_store(
            pos, status, m, cell_size, grid_size, origin, S, counts, e_const)
