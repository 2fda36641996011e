"""take_along_axis on one (S, 128) float32 tile: the CUDA kernel's wrapper
and its plain PyTorch twin.

Counterpart of ``scripts/experiment_sublane_gather.py::kernel``.
``sublane_gather(x, idx, variant)`` takes ``x`` (S, 128) float32 and int32
index tiles ``idx`` of shape (S, 128) or (B, S, 128) (one small table,
many index tiles; B = 1 is the TPU kernel's call), and returns float32 of
``idx``'s shape:

* ``"sublane"``: ``out[..., i, j] = x[idx[..., i, j], j]``, for indices in
  [0, S) (the contract: the twin raises outside it, the kernel writes NaN
  and reads nothing out of bounds);
* ``"both"``: with ``row = idx % S`` and ``col = (idx * 7) % 128`` (floor
  modulo, int32 products wrapping, as in jnp), ``g = take_along(x, row,
  rows)`` and then ``out = take_along(g, col, lanes)``, so that
  ``out[..., i, j] = x[row[..., i, col[..., i, j]], col[..., i, j]]``: a
  composition, not a 2-D gather.  Every index is in contract.

A CUDA tensor launches ``csrc/sublane_gather.cu``, a CPU tensor takes
``sublane_gather_plain``, any other device raises.  ``launches`` counts
kernel launches only.
"""

from __future__ import annotations

import torch

LANES = 128
VARIANTS = ("sublane", "both")


def _check(x, idx, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if x.dim() != 2 or x.shape[1] != LANES or x.dtype != torch.float32:
        raise ValueError(f"x must be an (S, {LANES}) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if idx.dtype != torch.int32 or idx.shape[-2:] != x.shape or \
            idx.dim() not in (2, 3):
        raise ValueError(f"idx must be int32 of shape (S, {LANES}) or "
                         f"(B, S, {LANES}) with S = {x.shape[0]}, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != x.device:
        raise ValueError("x and idx must be on one device")


def sublane_gather_plain(x, idx, variant: str = "sublane") -> torch.Tensor:
    _check(x, idx, variant)
    xb = x.expand(idx.shape)
    if variant == "sublane":
        return torch.gather(xb, -2, idx.long())
    row = idx % x.shape[0]
    col = (idx * 7) % LANES
    return torch.gather(torch.gather(xb, -2, row.long()), -1, col.long())


def sublane_gather(x, idx, variant: str = "sublane") -> torch.Tensor:
    """float32 of ``idx``'s shape: see the module note."""
    _check(x, idx, variant)
    if x.device.type == "cpu":
        return sublane_gather_plain(x, idx, variant)
    if x.device.type != "cuda":
        raise ValueError(f"no sublane-gather kernel for device {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    from . import build

    out = torch.empty(idx.shape, dtype=torch.float32, device=x.device)
    if idx.numel():
        build.load().call(
            "pst_sublane_gather", x.data_ptr(), idx.data_ptr(),
            out.data_ptr(), x.shape[0], idx.numel(), int(variant == "both"),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        sublane_gather.launches += 1
    return out


sublane_gather.launches = 0
