"""The field phase's gather: the CUDA kernel's wrappers and their plain
PyTorch twins.

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

Both launch ``csrc/field.cu`` on CUDA tensors (the source note there says
what bounds it) and take their ``*_plain`` twin on CPU tensors; on any
other device they raise.  ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import numpy as np
import torch

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
