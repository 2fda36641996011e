"""A T-step table lookup over int32 lanes (the engine's T loop in
miniature): the CUDA kernel's wrapper and its plain PyTorch twins.

Counterpart of ``scripts/microbench_lookup.py::kernel``.  For int32 lanes
``x`` (any shape, (TILES * 128, 128) in the probe) and two (C, 128)
float32 tables (C = 79 in the probe, C >= 8), each lane runs, for
t = 0 .. T-1 (T = 100, the script's T_STEPS)::

    idx = (x + 37 t) % 896 + 128;  hi = idx >> 7;  lo = idx & 127
    acc = (acc + split[hi, lo]) + remove[hi, lo];  x += 1

from ``acc = 0.0`` (int32 sums wrap, ``%`` is the floor modulo), and the
result is ``acc``, float32 of ``x``'s shape.  Variants of the kernel:
``"banked"`` (the 896 readable entries in shared memory as (split, remove)
pairs, 16 copies interleaved so that no load conflicts: the design),
``"paired"`` (banked's loop on one copy of the pairs, the engines' table
layout, whose loads conflict), ``"global"`` (tables through the read-only
cache), ``"shared"`` (whole tables staged in shared memory) and ``"none"``
(no lookup: zeros, the floor).  All but the last compute one function,
bitwise.

Two plain twins: ``lookup_bench_plain`` follows the formula above, and
``lookup_bench_incremental_plain`` the banked kernel's index rule (the
index stepped by 38 modulo 896, the formula for lanes whose x + 38t wraps
int32 within T steps).

A CUDA tensor launches ``csrc/lookup_bench.cu``, a CPU tensor takes
``lookup_bench_plain``, any other device raises.  ``launches`` counts
kernel launches only.
"""

from __future__ import annotations

import torch

LANES = 128
T_STEPS = 100
STRIDE = 37
SPAN = 7 * LANES   # 896
OFFSET = LANES     # idx in [128, 1024): table rows 1..7
STEP = STRIDE + 1  # x + 37t with x += 1 moves 38 a step
INT32_MAX = 2**31 - 1
VARIANTS = {"none": 0, "global": 1, "shared": 2, "banked": 3, "paired": 4}
MAX_SHARED_BYTES = 232_448  # a block's shared memory on Hopper
BANK_COPIES = 16
BANKED_BYTES = SPAN * BANK_COPIES * 8  # 114,688: float2 pairs, 16 copies


def _check(x, split2d, remove2d, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{variant!r}")
    if x.dtype != torch.int32:
        raise ValueError(f"x must be int32, got {x.dtype}")
    for name, t in (("split2d", split2d), ("remove2d", remove2d)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != LANES
                or t.shape[0] * LANES < OFFSET + SPAN):
            raise ValueError(f"{name} must be a (C, {LANES}) float32 table "
                             f"with C >= 8, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on x's device {x.device}")
    if split2d.shape != remove2d.shape:
        raise ValueError("split2d and remove2d must have one shape")


def lookup_bench_plain(x, split2d, remove2d,
                       variant: str = "global") -> torch.Tensor:
    _check(x, split2d, remove2d, variant)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if variant == "none":
        return acc
    for t in range(T_STEPS):
        idx = (x + STRIDE * t) % SPAN + OFFSET
        hi, lo = (idx >> 7).long(), (idx & (LANES - 1)).long()
        acc = (acc + split2d[hi, lo]) + remove2d[hi, lo]
        x = x + 1
    return acc


def lookup_bench_incremental_plain(x, split2d, remove2d,
                                   variant: str = "banked") -> torch.Tensor:
    """``lookup_bench_plain``'s function by the banked kernel's index rule:
    r = x mod 896 once, then r += 38 and r -= 896 where r >= 896 each step.
    A lane whose x + 38t would wrap int32 within T steps takes the formula
    (2^32 mod 896 = 256, so the stepped index would part from it)."""
    _check(x, split2d, remove2d, variant)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if variant == "none":
        return acc
    pairs_s = split2d.reshape(-1)[OFFSET:OFFSET + SPAN]
    pairs_r = remove2d.reshape(-1)[OFFSET:OFFSET + SPAN]
    wraps = x.long() > INT32_MAX - STEP * (T_STEPS - 1)
    r = x.long() % SPAN
    for t in range(T_STEPS):
        i = torch.where(wraps, ((x + STEP * t) % SPAN).long(), r)
        acc = (acc + pairs_s[i]) + pairs_r[i]
        r = r + STEP
        r = torch.where(r >= SPAN, r - SPAN, r)
    return acc


def banked_blocks_per_sm(device) -> int:
    """Resident blocks of the banked kernel per SM on CUDA ``device`` (the
    occupancy query its launch makes; two of 1024 threads on an H100)."""
    import ctypes

    from . import build

    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        build.load().call("pst_lookup_bench_banked_blocks",
                          ctypes.addressof(per_sm))
    return per_sm.value


def lookup_bench(x, split2d, remove2d, variant: str = "global") -> torch.Tensor:
    """float32 ``acc`` of ``x``'s shape: see the module note."""
    _check(x, split2d, remove2d, variant)
    if x.device.type == "cpu":
        return lookup_bench_plain(x, split2d, remove2d, variant)
    if x.device.type != "cuda":
        raise ValueError(f"no lookup kernel for device {x.device}")
    if not all(t.is_contiguous() for t in (x, split2d, remove2d)):
        raise ValueError("x and the tables must be contiguous")
    if variant == "shared" and 2 * split2d.numel() * 4 > MAX_SHARED_BYTES:
        raise ValueError("the tables do not fit a block's shared memory")
    from . import build

    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel():
        build.load().call(
            "pst_lookup_bench", x.data_ptr(), split2d.data_ptr(),
            remove2d.data_ptr(), out.data_ptr(), x.numel(), split2d.numel(),
            T_STEPS, VARIANTS[variant],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        lookup_bench.launches += 1
    return out


lookup_bench.launches = 0
