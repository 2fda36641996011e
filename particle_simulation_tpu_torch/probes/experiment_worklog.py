"""Row compaction with a carried pointer on the card (counterpart of
``scripts/experiment_worklog.py``).

Inputs as the script makes them: each int32 lane is a value in [1, 1000)
with probability 0.3 and 0 otherwise.  Two sizes:

1. the script's own, 4 tiles of (8, 128) = (32, 128), for exactness;
2. (16384, 128), about 2M lanes (the main path's slot count), for timing.

``kernels.compact.row_compact`` (csrc/compact.cu) is checked exactly
against its plain twin (``out`` and ``ptr``) at both sizes and at two more
calls made back to back on the same cached look-back state: the first 33
rows of the large input, and 777 rows with no positive element.  Then it
is timed with CUDA events beside the twin, two ways:

* warm (``common.time_ms``): one input, rerun; its 8 MiB in and 8 MiB out
  stay in the 50 MB L2, so it can beat the bytes bound;
* cold (``common.time_ms_cold``): rotating through rolled copies of the
  input, as many as ``rotation_sets`` gives (8 at (16384, 128): 128 MiB
  with their outputs, past twice the L2).  The kernel's time against its
  bound is the cold one.

No single PyTorch call computes a row compaction; ``x[x > 0]``, the flat
compaction, is timed warm as the nearest primitive, labelled so, and is
not the yardstick.

    python -m particle_simulation_tpu_torch.probes.experiment_worklog
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Tuple

import torch

from ..ops.kernels.compact import LANES, row_compact, row_compact_plain
from .common import (
    Timing, card, require_cuda, rotation_sets, time_ms, time_ms_cold,
)

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
    """The kernel against its plain twin, exactly, at both sizes and then
    at 33 rows and at 777 empty rows, the calls back to back on one cached
    look-back state; returns the largest absolute difference (0)."""
    cases = (("script's 4 x (8, 128)", inp.script),
             (f"{tuple(inp.x.shape)}", inp.x),
             ("33 rows after it", inp.x[:33]),
             ("777 rows, all empty", -inp.x[:777]))
    results = [row_compact(x) for _, x in cases]
    for (name, x), (out, ptr) in zip(cases, results):
        want_out, want_ptr = row_compact_plain(x)
        if int(ptr) != int(want_ptr) or not torch.equal(out, want_out):
            raise AssertionError(f"row_compact at {name}: differs from plain "
                                 f"(ptr {int(ptr)} vs {int(want_ptr)})")
    return 0.0


def timings(inp: Inputs, reps: int = 20) -> Timing:
    x = inp.x
    n_bytes = 2 * x.numel() * 4
    sets = rotation_sets(n_bytes)
    rolled = [(x.roll(k * 997, 0),) for k in range(sets)]
    warm_ms = time_ms(row_compact, x, reps=reps)
    cold_ms = time_ms_cold(row_compact, rolled)
    floor_ms = time_ms(row_compact, inp.script, reps=reps)
    copied = [(torch.empty_like(a), a) for (a,) in rolled]
    copy_warm_ms = time_ms(torch.Tensor.copy_, *copied[0], reps=reps)
    copy_cold_ms = time_ms_cold(torch.Tensor.copy_, copied)
    del copied
    del rolled
    plain_ms = time_ms(row_compact_plain, x, reps=reps)
    flat_ms = time_ms(lambda t: t[t > 0], x, reps=reps)
    shape = f"{tuple(x.shape)} int32, density {DENSITY}"
    lines = [
        (f"row_compact kernel, {shape}, warm (one input)",
         f"{warm_ms:.4f} ms"),
        (f"row_compact kernel, cold ({sets} inputs rotating, "
         f"{sets * n_bytes / 2**20:.0f} MiB with outputs)",
         f"{cold_ms:.4f} ms"),
        (f"row_compact kernel, {tuple(inp.script.shape)} (a launch's floor)",
         f"{floor_ms:.4f} ms"),
        ("the same bytes by Tensor.copy_ (a streaming floor; not the "
         "function), warm / cold",
         f"{copy_warm_ms:.4f} / {copy_cold_ms:.4f} ms"),
        ("row_compact_plain (warm)", f"{plain_ms:.4f} ms"),
        ("x[x > 0] (nearest primitive, not a row compaction; warm)",
         f"{flat_ms:.4f} ms"),
    ]
    return Timing(ms=cold_ms, plain_ms=plain_ms, library_ms=None,
                  bytes=n_bytes, ops=OPS_PER_LANE * x.numel(), lines=lines,
                  extra={"ms_warm": warm_ms, "ms_cold": cold_ms})


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
