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

A CUDA tensor launches ``csrc/compact.cu`` (one launch a call: one pass
with a decoupled look-back across blocks, each block zeroing its share of
the tail; the source note says what bounds it), a CPU tensor takes
``row_compact_plain``, any other device raises.  ``launches`` counts
kernel launches only.

The kernel's state (a ticket, a count of finished tiles, and one look-back
word a tile of 128 rows) is a buffer kept per device and stream: zeroed
once when it is allocated or grown, and left zero by every call, so a call
fills nothing from the host.
"""

from __future__ import annotations

import torch

LANES = 128
TILE_ROWS = 128  # rows per tile of csrc/compact.cu (kTileRows)

# (device index, stream handle) -> int64 state words, zero between calls
_STATE = {}


def state_words(rows: int) -> int:
    """State words a call on ``rows`` rows uses: the ticket, the count of
    finished tiles, then one a tile."""
    return 2 + -(-rows // TILE_ROWS)


def _lookback_state(device: torch.device, stream: int, words: int):
    """The cached zero words of (device, stream), grown (and zeroed, the
    one fill) when a call needs more than it holds."""
    key = (device.index, stream)
    buf = _STATE.get(key)
    if buf is None or buf.numel() < words:
        held = 0 if buf is None else buf.numel()
        buf = torch.zeros(max(words, 2 * held), dtype=torch.int64,
                          device=device)
        _STATE[key] = buf
    return buf


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
    ptr = torch.empty((), dtype=torch.int32, device=x.device)
    if not rows:
        ptr.zero_()
        return out, ptr
    stream = torch.cuda.current_stream(x.device).cuda_stream
    state = _lookback_state(x.device, stream, state_words(rows))
    build.load().call("pst_row_compact", x.data_ptr(), out.data_ptr(),
                      ptr.data_ptr(), state.data_ptr(), rows, stream)
    row_compact.launches += 1
    return out, ptr


row_compact.launches = 0
