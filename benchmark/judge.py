"""The comparison that decides ``correct``.

The episodes of a run take the run's simulation seeds in turn, each one
runPIC row, so the plain reference (the configuration's ``reference``
module) runs once for each seed, after the window, and every episode is
held against its seed's:

* ``episodes_failed``: episodes that raised, overflowed or hit 0;
* ``episodes_counters_off``: episodes whose per-step counters (n, added,
  removed, overflow, pushes) differ from the reference's in any step;
* ``episodes_multiset_off``: episodes whose final particle multiset (every
  field and the ids, as bit patterns) has another fingerprint than the
  reference's; the fingerprint is a sum over rows of two 32-bit row
  hashes, so the order of the rows does not enter;
* ``rows_off``: in one episode drawn from the run's seed, the rows of the
  sorted final multiset that differ from the reference's, plus the
  difference of the row counts.

The program's float32 path and the reference compute the same operations
with the same roundings, so every number is exact: each limit is 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
LIMITS = {"episodes_failed": 0, "episodes_counters_off": 0,
          "episodes_multiset_off": 0, "rows_off": 0}
# two row hashes: (start word, multiplier), odd multipliers below 2^31
_HASHES = ((0x2545F491, 0x2C1B3C6D), (0x6A09E667, 0x297A2D39))


def rows_of_state(state) -> torch.Tensor:
    """(n, 12) int32 rows of a port state's live prefix: pos, vel, acc as
    float32 bit patterns, status, id_hi, id_lo."""
    n = state.n_clamped
    return torch.cat([
        state.pos[:n].contiguous().view(torch.int32),
        state.vel[:n].contiguous().view(torch.int32),
        state.acc[:n].contiguous().view(torch.int32),
        state.status[:n, None], state.id_hi[:n, None], state.id_lo[:n, None],
    ], dim=1)


def fingerprint(rows: torch.Tensor) -> torch.Tensor:
    """An order-free fingerprint of a multiset of int32 rows: (row count,
    sum of hash 1, sum of hash 2) as a (3,) int64 tensor on the rows'
    device (nothing is read back).  Each product stays below 2^63 and each
    sum below 2^63 for up to 2^31 rows."""
    words = rows.to(torch.int64) & MASK
    out = [torch.tensor(rows.shape[0], dtype=torch.int64, device=rows.device)]
    for start, mult in _HASHES:
        h = torch.full((rows.shape[0],), start, dtype=torch.int64,
                       device=rows.device)
        for j in range(rows.shape[1]):
            h = ((h ^ words[:, j]) * mult) & MASK
            h = h ^ (h >> 15)
        out.append(h.sum())
    return torch.stack(out)


def sort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Rows in lexicographic order (stable sorts from the last column)."""
    order = torch.arange(rows.shape[0], device=rows.device)
    for j in reversed(range(rows.shape[1])):
        key = rows[order, j]
        order = order[torch.sort(key, stable=True).indices]
    return rows[order]


def rows_off(program: torch.Tensor, reference: torch.Tensor) -> int:
    """Rows of two sorted multisets that differ, plus their count gap."""
    a, b = sort_rows(program), sort_rows(reference.to(program.device))
    m = min(a.shape[0], b.shape[0])
    differ = int((a[:m] != b[:m]).any(dim=1).sum())
    return differ + abs(a.shape[0] - b.shape[0])


def compare(counters: Sequence[List[Tuple]], prints: Sequence[torch.Tensor],
            failed: int, sample: Optional[Tuple[int, torch.Tensor]],
            refs: Sequence) -> Dict[str, int]:
    """The numbers compared, from every episode's counters and fingerprint
    and the sampled (episode index, rows), against the references'
    (``refs[k]`` has ``counters`` and ``rows``; episode i ran seed
    i mod len(refs))."""
    k = len(refs)
    want = [[tuple(c) for c in r.counters] for r in refs]
    ref_prints = torch.stack([fingerprint(r.rows).cpu() for r in refs])
    got = torch.stack(list(prints)).cpu() if prints else None
    multiset_off = 0 if got is None else int(
        (got != ref_prints[torch.arange(len(got)) % k]).any(dim=1).sum())
    if sample is None:
        sampled_off = refs[0].rows.shape[0]
    else:
        sampled_off = rows_off(sample[1], refs[sample[0] % k].rows)
    return {
        "episodes_failed": failed,
        "episodes_counters_off": sum(
            [tuple(c) for c in ep] != want[i % k]
            for i, ep in enumerate(counters)),
        "episodes_multiset_off": multiset_off,
        "rows_off": sampled_off,
    }


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
