"""take_along_axis on sublanes and on both axes, on the card (counterpart
of ``scripts/experiment_sublane_gather.py``).

For S = 8, 32 and 128: an (S, 128) float32 tile (normal) and int32 index
tiles uniform in [0, S), from a seeded CPU generator.  Two batch sizes:

* B = 1, the script's call (a single tile: this times the launch);
* B = 2,097,152 / (128 S) index tiles over the one table (2M elements,
  the main path's slot count), as a lookup reads one small table.

``kernels.sublane_gather.sublane_gather`` (csrc/sublane_gather.cu) is
checked exactly against its plain twin for both variants at every (S, B),
then timed with CUDA events beside the twin and the PyTorch calls: one
``torch.take_along_dim`` computes ``"sublane"``; ``"both"`` takes two calls
(a row and a lane take_along_dim), timed together and labelled so.  Both
PyTorch timings take int64 indices made beforehand (their index type).
The timing line for the kernel table is ``"sublane"`` at S = 128, B = 128.

    python -m particle_simulation_tpu_torch.probes.experiment_sublane_gather
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import torch

from ..ops.kernels.sublane_gather import (
    LANES, VARIANTS, sublane_gather, sublane_gather_plain,
)
from .common import Timing, card, require_cuda, time_ms

SUBLANES = (8, 32, 128)
ELEMENTS = 2_097_152
MAIN = (128, ELEMENTS // (LANES * 128), "sublane")  # (S, B, variant)
OPS = {"sublane": 1, "both": 4}  # index arithmetic per element


def make_inputs(seed: int = 0, device="cuda"
                ) -> Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]:
    """(S, B) -> (x (S, 128) float32, idx (B, S, 128) int32) on ``device``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for s in SUBLANES:
        x = torch.randn((s, LANES), generator=g, dtype=torch.float32)
        for b in (1, ELEMENTS // (LANES * s)):
            idx = torch.randint(0, s, (b, s, LANES), generator=g,
                                dtype=torch.int32)
            out[(s, b)] = (x.to(device), idx.to(device))
    return out


def _library(x, idx64, variant):
    xb = x.expand(idx64.shape[-3:])
    if variant == "sublane":
        return torch.take_along_dim(xb, idx64, dim=-2)
    row, col = idx64
    return torch.take_along_dim(torch.take_along_dim(xb, row, dim=-2), col,
                                dim=-1)


def _library_args(x, idx, variant):
    if variant == "sublane":
        return idx.long()
    return torch.stack([(idx % x.shape[0]).long(), ((idx * 7) % LANES).long()])


def check(inp) -> float:
    """Kernel against plain twin (and the PyTorch calls), exactly, for
    every (S, B, variant); returns the largest absolute difference (0)."""
    for (s, b), (x, idx) in inp.items():
        for variant in VARIANTS:
            got = sublane_gather(x, idx, variant)
            want = sublane_gather_plain(x, idx, variant)
            lib = _library(x, _library_args(x, idx, variant), variant)
            if not (torch.equal(got, want) and torch.equal(got, lib)):
                raise AssertionError(f"sublane_gather {variant} at S={s}, "
                                     f"B={b}: differs from plain")
    return 0.0


def timings(inp, reps: int = 20) -> Timing:
    lines = []
    main = None
    for (s, b), (x, idx) in inp.items():
        tag = f"S={s} B={b}" + (" (launch-bound)" if b == 1 else "")
        for variant in VARIANTS:
            lib_args = _library_args(x, idx, variant)
            ms = time_ms(sublane_gather, x, idx, variant, reps=reps)
            plain_ms = time_ms(sublane_gather_plain, x, idx, variant, reps=reps)
            lib_ms = time_ms(_library, x, lib_args, variant, reps=reps)
            lib = ("take_along_dim" if variant == "sublane"
                   else "two take_along_dim calls")
            lines.append((f"sublane_gather {variant}, {tag}",
                          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                          f"{lib} {lib_ms:.4f} ms"))
            if (s, b, variant) == MAIN:
                main = (ms, plain_ms, lib_ms, x, idx)
    ms, plain_ms, lib_ms, x, idx = main
    return Timing(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                  bytes=(x.numel() + 2 * idx.numel()) * 4,
                  ops=OPS[MAIN[2]] * idx.numel(), lines=lines)


def run(device, reps: int = 20) -> List[Tuple[str, str]]:
    """Check and time on ``device`` (CUDA); returns (label, value) lines."""
    inp = make_inputs(device=require_cuda(device))
    check(inp)
    return timings(inp, reps).lines


def main() -> int:
    if not torch.cuda.is_available():
        print("experiment_sublane_gather: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(f"{card()}; S in {SUBLANES}, {ELEMENTS} elements at the large B",
          flush=True)
    for label, value in run(torch.device("cuda", 0)):
        print(f"{label:52s} {value}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
