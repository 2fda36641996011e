"""Row compaction with a carried pointer on the card (counterpart of
``scripts/experiment_worklog.py``).

Inputs as the script makes them: each int32 lane is a value in [1, 1000)
with probability 0.3 and 0 otherwise.  Two sizes:

1. the script's own, 4 tiles of (8, 128) = (32, 128), for exactness;
2. (16384, 128), about 2M lanes (the main path's slot count), for timing.

``kernels.compact.row_compact`` (csrc/compact.cu) is checked exactly
against its plain twin (``out`` and ``ptr``) at both sizes, then timed with
CUDA events beside the twin.  No single PyTorch call computes a row
compaction; ``x[x > 0]``, the flat compaction, is timed as the nearest
primitive, labelled so, and is not the yardstick.

    python -m particle_simulation_tpu_torch.probes.experiment_worklog
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Tuple

import torch

from ..ops.kernels.compact import LANES, row_compact, row_compact_plain
from .common import Timing, card, require_cuda, time_ms

SCRIPT_ROWS = 4 * 8   # the script's 4 tiles of (8, 128)
ROWS = 16384          # 2,097,152 lanes
DENSITY = 0.3
OPS_PER_LANE = 2      # the compare and the rank's add


class Inputs(NamedTuple):
    script: torch.Tensor  # (32, 128) int32
    x: torch.Tensor       # (ROWS, 128) int32


def make_lanes(rows: int, density: float = DENSITY, seed: int = 0,
               device="cuda") -> torch.Tensor:
    """(rows, 128) int32 from a seeded CPU generator, moved to ``device``."""
    g = torch.Generator().manual_seed(seed)
    keep = torch.rand((rows, LANES), generator=g) < density
    vals = torch.randint(1, 1000, (rows, LANES), generator=g, dtype=torch.int32)
    return (vals * keep).to(device)


def make_inputs(seed: int = 0, device="cuda") -> Inputs:
    return Inputs(make_lanes(SCRIPT_ROWS, seed=seed, device=device),
                  make_lanes(ROWS, seed=seed + 1, device=device))


def check(inp: Inputs) -> float:
    """The kernel against its plain twin at both sizes, exactly; returns the
    largest absolute difference (0)."""
    for name, x in (("script's 4 x (8, 128)", inp.script),
                    (f"{tuple(inp.x.shape)}", inp.x)):
        out, ptr = row_compact(x)
        want_out, want_ptr = row_compact_plain(x)
        if int(ptr) != int(want_ptr) or not torch.equal(out, want_out):
            raise AssertionError(f"row_compact at {name}: differs from plain "
                                 f"(ptr {int(ptr)} vs {int(want_ptr)})")
    return 0.0


def timings(inp: Inputs, reps: int = 20) -> Timing:
    x = inp.x
    ms = time_ms(row_compact, x, reps=reps)
    plain_ms = time_ms(row_compact_plain, x, reps=reps)
    flat_ms = time_ms(lambda t: t[t > 0], x, reps=reps)
    shape = f"{tuple(x.shape)} int32, density {DENSITY}"
    lines = [
        (f"row_compact kernel, {shape}", f"{ms:.4f} ms"),
        ("row_compact_plain", f"{plain_ms:.4f} ms"),
        ("x[x > 0] (nearest primitive, not a row compaction)",
         f"{flat_ms:.4f} ms"),
    ]
    return Timing(ms=ms, plain_ms=plain_ms, library_ms=None,
                  bytes=2 * x.numel() * 4, ops=OPS_PER_LANE * x.numel(),
                  lines=lines)


def run(device, reps: int = 20) -> List[Tuple[str, str]]:
    """Check and time on ``device`` (CUDA); returns (label, value) lines."""
    inp = make_inputs(device=require_cuda(device))
    check(inp)
    return timings(inp, reps).lines


def main() -> int:
    if not torch.cuda.is_available():
        print("experiment_worklog: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(f"{card()}; rows {ROWS} x {LANES} int32, density {DENSITY}",
          flush=True)
    for label, value in run(torch.device("cuda", 0)):
        print(f"{label:52s} {value}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
