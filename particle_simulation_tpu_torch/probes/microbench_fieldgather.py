"""Field-gather primitives on the card (counterpart of
``scripts/microbench_fieldgather.py``, at its sizes).

1,310,720 clustered cell ids (a Gaussian ball, sd 10 cells, in 64^3) index
the packed (2048, 128) int32 table of a 64^3 bbox subgrid.  Timed with CUDA
events, each as ms per call after a warm-up:

1. torch gather from the flat table, random and sorted order;
2. ``torch.sort`` and a stable ``argsort`` of the ids;
3. a permutation of (N, 12) int32 rows (the state reorder a cell sort
   would need);
4. ``kernels.field.banded_gather`` (csrc/field.cu) on sorted and on random
   ids, and its plain twin, each checked exactly against
   ``table.view(-1)[ids]``;
5. the row band of each 128x128 tile of sorted ids (mean and max);
6. the bound of ``banded_gather``: the least time the H100 could take to
   read the row and lane ids and the table once and write the output once.

    python -m particle_simulation_tpu_torch.probes.microbench_fieldgather
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Tuple

import torch

from ..ops.kernels.field import banded_gather, banded_gather_plain
from .common import bound_ms, card, require_cuda, time_ms

N = 1_310_720
R, L = 2048, 128  # the packed table: 64^3 cells as (2048, 128) int32
SUB = 128         # tile rows of the band statistics (the TPU kernel's tile)


class Inputs(NamedTuple):
    table: torch.Tensor       # (R, L) int32
    ids: torch.Tensor         # (n,) int32 flat cell ids, random order
    ids_sorted: torch.Tensor  # (n,) int32, ascending


def make_inputs(n: int = N, seed: int = 0, device="cuda") -> Inputs:
    """The table and ids from a seeded CPU generator, moved to ``device``."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randint(0, 1 << 30, (R, L), generator=g, dtype=torch.int32)
    xyz = (32 + 10 * torch.randn((n, 3), generator=g)).to(torch.int32)
    xyz = xyz.clamp(0, 63)
    ids = (xyz[:, 0] * 64 + xyz[:, 1]) * 64 + xyz[:, 2]
    return Inputs(table.to(device), ids.to(device),
                  torch.sort(ids).values.to(device))


def split(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat ids -> the kernel's (n/128, 128) rows and lanes."""
    return (ids >> 7).reshape(-1, L), (ids & (L - 1)).reshape(-1, L)


def band_stats(ids_sorted: torch.Tensor) -> Tuple[float, int]:
    """Mean and max rows spanned by each (SUB, 128) tile of sorted ids."""
    rows = (ids_sorted >> 7).reshape(-1, SUB, L)
    span = rows.amax((1, 2)) - rows.amin((1, 2)) + 1
    return float(span.double().mean()), int(span.max())


def _require_equal(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: differs from table.view(-1)[ids]")


def run(device, reps: int = 20) -> List[Tuple[str, str]]:
    """Check and time every primitive on ``device`` (CUDA); returns
    (label, value) lines."""
    inp = make_inputs(device=require_cuda(device))
    flat_table = inp.table.view(-1)
    ids64, sorted64 = inp.ids.long(), inp.ids_sorted.long()
    g = torch.Generator().manual_seed(1)
    rows12 = torch.randint(0, 1 << 30, (N, 12), generator=g,
                           dtype=torch.int32).to(device)
    perm = torch.argsort(inp.ids, stable=True)
    out = []

    def line(label, ms):
        out.append((label, f"{ms:.4f} ms"))

    line("torch gather, random order",
         time_ms(flat_table.__getitem__, ids64, reps=reps))
    line("torch gather, sorted ids",
         time_ms(flat_table.__getitem__, sorted64, reps=reps))
    line("torch.sort of the ids", time_ms(torch.sort, inp.ids, reps=reps))
    line("stable argsort of the ids",
         time_ms(lambda f: torch.argsort(f, stable=True), inp.ids, reps=reps))
    line("(N, 12) row permutation",
         time_ms(rows12.__getitem__, perm, reps=reps))
    for order, ids, ids_long in (("sorted", inp.ids_sorted, sorted64),
                                 ("random", inp.ids, ids64)):
        rows, lanes = split(ids)
        want = flat_table[ids_long].reshape(rows.shape)
        _require_equal(banded_gather(inp.table, rows, lanes), want,
                       f"banded_gather, {order}")
        _require_equal(banded_gather_plain(inp.table, rows, lanes), want,
                       f"banded_gather_plain, {order}")
        line(f"banded_gather kernel, {order} ids (exact)",
             time_ms(banded_gather, inp.table, rows, lanes, reps=reps))
        line(f"banded_gather_plain, {order} ids (exact)",
             time_ms(banded_gather_plain, inp.table, rows, lanes, reps=reps))
    mean, mx = band_stats(inp.ids_sorted)
    out.append(("sorted tile row band", f"mean {mean:.2f} rows, max {mx}"))
    bound, by = bound_ms(3 * 4 * N + inp.table.numel() * 4, 0)
    out.append(("banded_gather bound", f"{bound:.4f} ms ({by})"))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_fieldgather: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(f"{card()}; N={N}, table ({R}, {L}) int32", flush=True)
    for label, value in run(torch.device("cuda", 0)):
        print(f"{label:44s} {value}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
