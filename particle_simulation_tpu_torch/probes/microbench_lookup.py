"""The 100-step table lookup on the card (counterpart of
``scripts/microbench_lookup.py``, at its sizes: 60 tiles of (128, 128)
int32 lanes, T = 100 steps, two (79, 128) float32 tables).

Lanes uniform in [0, 896) and tables uniform in [0, 1), from a seeded CPU
generator.  ``kernels.lookup_bench.lookup_bench`` (csrc/lookup_bench.cu)
runs in its five variants, which stand for the TPU kernel's modes so:

* ``banked``: the kernel's design; the readable entries in shared memory
  as (split, remove) pairs, 16 copies interleaved so that no load
  conflicts; computes what modes a-d compute (each a band sweep over the
  table, since the TPU has no per-lane gather);
* ``paired``: banked's loop on one copy of the pairs, the layout of the
  engines' shared table (csrc/lookup.cuh): its loads conflict, so banked
  against paired is what the 16 copies save at scattered buckets;
* ``shared``: the whole tables staged in shared memory once per block, as
  modes a-d hold them in VMEM (mode b also pre-broadcasts them there);
* ``global``: the tables through the read-only cache, the read that
  csrc/lookup.cuh's global overload makes;
* ``none``: no lookup, mode e (the floor).

Every variant but ``none`` is checked bitwise against the
plain twin, ``none`` against zeros; then each is timed warm with CUDA
events (``common.time_ms``: the function is bound by its operations, its
7.9 MB of lanes fit the L2) beside the twin (a Python loop of 100 steps).
No single PyTorch call computes the function, so it has no library time.
The kernel's time is ``banked``'s, with the others beside it.

    python -m particle_simulation_tpu_torch.probes.microbench_lookup
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Tuple

import torch

from ..ops.kernels.lookup_bench import (
    BANKED_BYTES, LANES, SPAN, T_STEPS, VARIANTS, banked_blocks_per_sm,
    lookup_bench, lookup_bench_plain,
)
from .common import Timing, card, require_cuda, time_ms

TILES = 60
N_CHUNKS = 79
OPS_PER_STEP = 8  # x + 37t, mod, + 128, >> 7, & 127, two adds, x + 1
SHARED_BYTES_PER_STEP = 8  # the banked kernel's (split, remove) pair
SM_CLOCK_HZ = 1.98e9       # the H100 SXM's boost clock
MODES = {"banked": "TPU modes a-d, conflict-free shared table",
         "paired": "TPU modes a-d, one copy of the pairs",
         "shared": "TPU modes a-d, tables on chip",
         "global": "TPU modes a-d, read-only cache", "none": "TPU mode e"}


class Inputs(NamedTuple):
    x: torch.Tensor       # (TILES * 128, 128) int32
    split: torch.Tensor   # (N_CHUNKS, 128) float32
    remove: torch.Tensor  # (N_CHUNKS, 128) float32


def make_inputs(tiles: int = TILES, seed: int = 0, device="cuda") -> Inputs:
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, SPAN, (tiles * LANES, LANES), generator=g,
                      dtype=torch.int32)
    split = torch.rand((N_CHUNKS, LANES), generator=g, dtype=torch.float32)
    remove = torch.rand((N_CHUNKS, LANES), generator=g, dtype=torch.float32)
    return Inputs(x.to(device), split.to(device), remove.to(device))


def check(inp: Inputs) -> float:
    """Every variant against the plain twin, bitwise; returns the largest
    absolute difference (0)."""
    want = lookup_bench_plain(*inp, "global")
    for variant in VARIANTS:
        got = lookup_bench(*inp, variant)
        ref = torch.zeros_like(want) if variant == "none" else want
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"lookup_bench {variant}: differs from plain")
    return 0.0


def timings(inp: Inputs, reps: int = 20) -> Timing:
    lines = [("lookup_bench banked: blocks of 1024 threads per SM, "
              f"{BANKED_BYTES} B of shared memory each",
              f"{banked_blocks_per_sm(inp.x.device)}")]
    ms = {}
    for variant in MODES:
        ms[variant] = time_ms(lookup_bench, *inp, variant, reps=reps)
        lines.append((f"lookup_bench {variant} ({MODES[variant]})",
                      f"{ms[variant]:.4f} ms"))
    lane_steps = inp.x.numel() * T_STEPS
    sms = torch.cuda.get_device_properties(inp.x.device).multi_processor_count
    rate = SHARED_BYTES_PER_STEP * lane_steps / (ms["banked"] * 1e-3)
    lines.append(("lookup_bench banked: shared-memory loads (8 B a lane-step)",
                  f"{rate:.4g} B/s, {rate / sms / SM_CLOCK_HZ:.1f} B a clock "
                  f"an SM at {SM_CLOCK_HZ / 1e9:g} GHz (ceiling 128)"))
    plain_ms = time_ms(lookup_bench_plain, *inp, "global", reps=3)
    lines.append(("lookup_bench_plain (100-step torch loop)",
                  f"{plain_ms:.4f} ms"))
    return Timing(ms=ms["banked"], plain_ms=plain_ms, library_ms=None,
                  bytes=(2 * inp.x.numel() + inp.split.numel()
                         + inp.remove.numel()) * 4,
                  ops=OPS_PER_STEP * lane_steps, lines=lines,
                  extra={"ms_by_variant": ms})


def run(device, reps: int = 20) -> List[Tuple[str, str]]:
    """Check and time on ``device`` (CUDA); returns (label, value) lines."""
    inp = make_inputs(device=require_cuda(device))
    check(inp)
    return timings(inp, reps).lines


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_lookup: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(f"{card()}; {TILES} tiles of ({LANES}, {LANES}) int32, T={T_STEPS}, "
          f"tables ({N_CHUNKS}, {LANES}) float32", flush=True)
    for label, value in run(torch.device("cuda", 0)):
        print(f"{label:52s} {value}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
