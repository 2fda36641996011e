"""Row compaction with a carried pointer: the CUDA kernel's wrapper and its
plain PyTorch twin.

Counterpart of ``scripts/experiment_worklog.py::kernel``.  For an (R, 128)
int32 ``x``, ``row_compact(x)`` returns ``(out, ptr)``:

* in each row the elements > 0 move to the front in their order and the
  rest of the row is zero (zeros and negatives are dropped);
* the rows that keep an element are stacked in source order at the front
  of ``out`` (R, 128), and ``ptr`` (a 0-d int32 tensor on ``x``'s device)
  is their number;
* rows [ptr, R) of ``out`` are zero (the TPU kernel leaves them
  undefined).

A CUDA tensor launches ``csrc/compact.cu`` (one pass, decoupled look-back
across blocks; the source note says what bounds it), a CPU tensor takes
``row_compact_plain``, any other device raises.  ``launches`` counts
kernel launches only.
"""

from __future__ import annotations

import torch

LANES = 128
TILE_ROWS = 32  # rows per block of csrc/compact.cu (kTileRows)


def row_compact_plain(x: torch.Tensor):
    valid = x > 0
    counts = valid.sum(1)
    # a stable sort on "not valid" moves each row's valid lanes to the front
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    cols = torch.arange(LANES, device=x.device)
    rows = torch.where(cols < counts[:, None], torch.gather(x, 1, order),
                       torch.zeros_like(x))
    kept = rows[counts > 0]
    out = torch.zeros_like(x)
    out[: kept.shape[0]] = kept
    return out, torch.tensor(kept.shape[0], dtype=torch.int32, device=x.device)


def row_compact(x: torch.Tensor):
    """``(out, ptr)`` for an (R, 128) int32 ``x``: see the module note."""
    if x.dim() != 2 or x.shape[1] != LANES or x.dtype != torch.int32:
        raise ValueError(f"x must be an (R, {LANES}) int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return row_compact_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no row-compaction kernel for device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned (the "
                         "kernel loads a row as one int4 a thread)")
    from . import build

    rows = x.shape[0]
    out = torch.empty_like(x)
    ptr = torch.zeros((), dtype=torch.int32, device=x.device)
    if rows:
        tiles = -(-rows // TILE_ROWS)
        # the look-back words, then the ticket (csrc/lookback.cuh)
        state = torch.zeros(tiles + 1, dtype=torch.int64, device=x.device)
        build.load().call(
            "pst_row_compact", x.data_ptr(), out.data_ptr(), ptr.data_ptr(),
            state.data_ptr(), rows,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        row_compact.launches += 1
    return out, ptr


row_compact.launches = 0
