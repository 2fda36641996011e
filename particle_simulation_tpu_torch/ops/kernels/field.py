"""The field phase's kernels: the CUDA wrappers and their plain PyTorch
twins.

Counterpart of ``scripts/microbench_fieldgather.py::banded_gather_kernel``
(``out = table[rows, lanes]`` from a packed (2048, 128) int32 bbox table,
by a sweep over each tile's row band) and of the packed-diff gather of the
JAX package's field phase (``grid.gather_acceleration_packdiff`` and
``_subgrid_packdiff_acc``):

* ``banded_gather(table, rows, lanes)``: ``table[rows, lanes]``, the exact
  counterpart of the TPU kernel;
* ``packed_field_gather(packed, flat, weight, e_const)``: the field phase's
  gather, ``packed[flat]`` unpacked into three 10-bit diffs and scaled to
  ``float32(d) * float32(e_const)``, 0 where ``weight`` is 0.

And the bbox subgrid's field phase on a CUDA state, as three kernels over
the state's ``pos`` (capacity, 3) float32 and ``status`` (capacity,) int32,
of which the first ``m`` rows hold the population (``ops.grid.
subgrid_field_chain`` runs them):

* ``subgrid_bbox``: the six bounds words of the live rows' cells
  (``bbox_bounds`` reads ``live_bbox``'s bounds off them);
* ``subgrid_deposit``: the S^3 int32 counts of the live rows around a
  window origin;
* ``subgrid_field_store``: the state's new ``acc``, ``float32(c[+1] -
  c[-1]) * float32(e_const)`` per axis at each live row's cell (neighbours
  outside the window 0), 0 on every other row.

Each launches ``csrc/field.cu`` on CUDA tensors (the source note there says
what bounds it) and takes its ``*_plain`` twin on CPU tensors; on any
other device it raises.  ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..population import is_live

LANES = 128
PACK_BIAS = 1 << 9   # 10-bit biased fields: diff in [-512, 511]
PACK_MASK = (1 << 10) - 1


def _check_i32(name, t, device):
    if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous int32 tensor on {device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def banded_gather_plain(table, rows, lanes) -> torch.Tensor:
    return table[rows.long(), lanes.long()]


def banded_gather(table, rows, lanes) -> torch.Tensor:
    """``table[rows, lanes]`` for an (R, 128) int32 table and int32 row and
    lane indices of one shape, (N/128, 128) in the probe."""
    if table.dim() != 2 or table.shape[1] != LANES:
        raise ValueError(f"table must be (R, {LANES}), got {tuple(table.shape)}")
    if rows.shape != lanes.shape:
        raise ValueError("rows and lanes must have one shape")
    if table.device.type == "cpu":
        return banded_gather_plain(table, rows, lanes)
    if table.device.type != "cuda":
        raise ValueError(f"no field-gather kernel for device {table.device}")
    for name, t in (("table", table), ("rows", rows), ("lanes", lanes)):
        _check_i32(name, t, table.device)
    from . import build

    out = torch.empty_like(rows)
    if rows.numel():
        build.load().call(
            "pst_banded_gather", table.data_ptr(), rows.data_ptr(),
            lanes.data_ptr(), out.data_ptr(), rows.numel(),
            _stream(table.device),
        )
        banded_gather.launches += 1
    return out


banded_gather.launches = 0


def unpack_diffs(v: torch.Tensor) -> torch.Tensor:
    """Packed int32 values (m,) -> their (m, 3) int32 diffs (dx in bits
    20-29, dy 10-19, dz 0-9; ``ops.grid.pack_diffs`` packs them)."""
    return torch.stack([(v >> 20) - PACK_BIAS,
                        ((v >> 10) & PACK_MASK) - PACK_BIAS,
                        (v & PACK_MASK) - PACK_BIAS], dim=1)


def packed_field_gather_plain(packed, flat, weight, e_const) -> torch.Tensor:
    d = unpack_diffs(packed[flat.clamp(min=0).long()])
    e = torch.tensor(np.float32(e_const), device=packed.device)
    acc = d.to(torch.float32) * e
    return torch.where(weight[:, None] > 0, acc, torch.zeros_like(acc))


def packed_field_gather(packed, flat, weight, e_const) -> torch.Tensor:
    """(m, 3) float32 field of the particles at cells ``flat`` (m,) of the
    flat packed diff grid ``packed``; ``flat`` is -1 for a dead slot (in
    [-1, packed.numel()) by contract) and ``weight`` (m,) int32 is 0 there."""
    if packed.dim() != 1 or flat.dim() != 1 or weight.shape != flat.shape:
        raise ValueError("packed must be flat; flat and weight (m,) alike")
    if packed.device.type == "cpu":
        return packed_field_gather_plain(packed, flat, weight, e_const)
    if packed.device.type != "cuda":
        raise ValueError(f"no field-gather kernel for device {packed.device}")
    for name, t in (("packed", packed), ("flat", flat), ("weight", weight)):
        _check_i32(name, t, packed.device)
    from . import build

    m = flat.numel()
    out = torch.empty((m, 3), dtype=torch.float32, device=packed.device)
    if m:
        build.load().call(
            "pst_packed_field_gather", packed.data_ptr(), flat.data_ptr(),
            weight.data_ptr(), float(np.float32(e_const)), out.data_ptr(), m,
            _stream(packed.device),
        )
        packed_field_gather.launches += 1
    return out


packed_field_gather.launches = 0


def _check_rows(pos, status, m):
    """The state's rows as the subgrid kernels take them."""
    if (pos.dtype != torch.float32 or pos.dim() != 2 or pos.shape[1] != 3
            or not pos.is_contiguous()):
        raise ValueError("pos must be a contiguous (capacity, 3) float32 tensor")
    if status.shape != pos.shape[:1]:
        raise ValueError("status must be (capacity,) like pos")
    _check_i32("status", status, pos.device)
    if not 0 <= m <= pos.shape[0]:
        raise ValueError(f"m {m} outside [0, capacity {pos.shape[0]}]")


def _device(pos):
    """'cpu' for the plain twin, 'cuda' for the kernel; raises elsewhere."""
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no field kernel for device {pos.device}")
    return pos.device.type


def _inv(cell_size) -> float:
    return float(np.float32(1.0 / cell_size))


def _live_cells(pos, status, m, cell_size, grid_size):
    """(cells (m, 3) int32, live (m,) bool) of the first ``m`` rows: the
    cells of ``ops.grid.cell_indices``."""
    from ..grid import cell_indices

    return (cell_indices(pos[:m], cell_size, grid_size),
            is_live(status[:m]))


def _window_cells(pos, status, m, cell_size, grid_size, origin, subgrid):
    """(rel (m, 3) int32, inside (m,) bool): each row's cell relative to
    ``origin``; a live row inside the S^3 window is ``inside``."""
    cells, live = _live_cells(pos, status, m, cell_size, grid_size)
    rel = cells - torch.tensor(origin, dtype=torch.int32, device=pos.device)
    return rel, live & ((rel >= 0) & (rel < subgrid)).all(1)


def bbox_bounds(words, grid_size):
    """(lo, hi) lists of ``live_bbox``'s bounds from the six words of
    ``subgrid_bbox`` read back: lo = g - words[a], hi = words[3 + a] - 1,
    so that no live row gives lo = g, hi = -1."""
    return ([g - w for g, w in zip(grid_size, words[:3])],
            [w - 1 for w in words[3:]])


def subgrid_bbox_plain(pos, status, m, cell_size, grid_size) -> torch.Tensor:
    cells, live = _live_cells(pos, status, m, cell_size, grid_size)
    g = torch.tensor(grid_size, dtype=torch.int32, device=pos.device)
    zero = torch.zeros((1, 3), dtype=torch.int32, device=pos.device)
    words = [torch.cat([torch.where(live[:, None], w, 0), zero]).amax(0)
             for w in (g - cells, cells + 1)]
    return torch.cat(words)


def subgrid_bbox(pos, status, m, cell_size, grid_size) -> torch.Tensor:
    """(6,) int32 words of the live rows among the first ``m``: for each
    axis the largest ``g - cell``, then the largest ``cell + 1``, 0 when no
    row is live (``bbox_bounds`` decodes them)."""
    _check_rows(pos, status, m)
    if _device(pos) == "cpu":
        return subgrid_bbox_plain(pos, status, m, cell_size, grid_size)
    from . import build

    words = torch.empty(6, dtype=torch.int32, device=pos.device)
    build.load().call(
        "pst_subgrid_bbox", pos.data_ptr(), status.data_ptr(), m,
        _inv(cell_size), *grid_size, words.data_ptr(), _stream(pos.device))
    subgrid_bbox.launches += 1
    return words


subgrid_bbox.launches = 0


def subgrid_deposit_plain(pos, status, m, cell_size, grid_size, origin,
                          subgrid) -> torch.Tensor:
    S = subgrid
    rel, inside = _window_cells(pos, status, m, cell_size, grid_size,
                                origin, S)
    flat = ((rel[:, 0] * S + rel[:, 1]) * S + rel[:, 2])[inside]
    counts = torch.zeros(S ** 3, dtype=torch.int32, device=pos.device)
    return counts.index_add_(0, flat.long(), torch.ones_like(flat))


def subgrid_deposit(pos, status, m, cell_size, grid_size, origin,
                    subgrid) -> torch.Tensor:
    """(S^3,) int32 counts of the live rows among the first ``m`` at their
    cell relative to ``origin`` (x-major); a row outside the window adds
    nothing."""
    _check_rows(pos, status, m)
    if _device(pos) == "cpu":
        return subgrid_deposit_plain(pos, status, m, cell_size, grid_size,
                                     origin, subgrid)
    from . import build

    counts = torch.empty(subgrid ** 3, dtype=torch.int32, device=pos.device)
    build.load().call(
        "pst_subgrid_deposit", pos.data_ptr(), status.data_ptr(), m,
        _inv(cell_size), *grid_size, *origin, subgrid, counts.data_ptr(),
        _stream(pos.device))
    subgrid_deposit.launches += 1
    return counts


subgrid_deposit.launches = 0


def subgrid_field_store_plain(pos, status, m, cell_size, grid_size, origin,
                              subgrid, counts, e_const) -> torch.Tensor:
    S = subgrid
    rel, inside = _window_cells(pos, status, m, cell_size, grid_size,
                                origin, S)
    padded = torch.zeros((S + 2,) * 3, dtype=torch.int32, device=pos.device)
    padded[1:-1, 1:-1, 1:-1] = counts.reshape(S, S, S)
    at = rel[inside].long() + 1
    diffs = []
    for a in range(3):
        up, down = at.clone(), at.clone()
        up[:, a] += 1
        down[:, a] -= 1
        diffs.append(padded[tuple(up.T)] - padded[tuple(down.T)])
    e = torch.tensor(np.float32(e_const), device=pos.device)
    acc = torch.zeros_like(pos)
    acc[:m][inside] = torch.stack(diffs, 1).to(torch.float32) * e
    return acc


def subgrid_field_store(pos, status, m, cell_size, grid_size, origin,
                        subgrid, counts, e_const) -> torch.Tensor:
    """A new (capacity, 3) float32 ``acc``: on each live row among the first
    ``m`` whose cell lies in the window, ``float32(c[+1] - c[-1]) *
    float32(e_const)`` per axis from the (S^3,) int32 ``counts`` at
    ``origin`` (neighbours outside the window 0); 0 on every other row."""
    _check_rows(pos, status, m)
    S = subgrid
    if counts.shape != (S ** 3,):
        raise ValueError(f"counts must be ({S ** 3},), got {tuple(counts.shape)}")
    if _device(pos) == "cpu":
        return subgrid_field_store_plain(pos, status, m, cell_size,
                                         grid_size, origin, S, counts,
                                         e_const)
    _check_i32("counts", counts, pos.device)
    from . import build

    acc = torch.empty_like(pos)
    build.load().call(
        "pst_subgrid_field_store", pos.data_ptr(), status.data_ptr(), m,
        pos.shape[0], _inv(cell_size), *grid_size, *origin, S,
        counts.data_ptr(), float(np.float32(e_const)), acc.data_ptr(),
        _stream(pos.device))
    subgrid_field_store.launches += 1
    return acc


subgrid_field_store.launches = 0
