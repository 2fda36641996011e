"""The least time an H100 could take for a mobility phase of the general
instantiation under the magnetized-argon model (``csrc/physics.cuh``: the
Boris rotation, the periodic wrap, isotropic children), frozen here so
that the yardstick does not move with the program.  It adds to
``bound``'s lane-step the operations of the port's smoke run for this
model (``chip_smoke.py`` ``OPS_PER_PUSH_MODELS``,
``OPS_PER_ISOTROPIC_CHILD``; an FMA counts two):

* the Boris rotation in place of the leapfrog kick and drift, +36 a push
  (the fused and the rounded ``v - h`` per axis, 9; per output axis two
  ``v'`` terms of 4 and the final cross term, add and subtract, 5: 39;
  the drift, 6; against the leapfrog's 18);
* the periodic wrap in place of the bounds test, +15 a push (``fmodf``,
  the sign fix, the clamp and ``nextafterf``, 7 an axis, against 6
  compares);
* an isotropic child's velocity, 22 a child (the two uniforms, cos_t,
  sin_t, phi, the speed, cos, sin, three products).

The children of a phase are counted as ``max(0, rows out - rows in)``, at
most the children it made (absorbed rows are subtracted), so the bound
is a lower bound and the share cannot read high.  Bytes and peaks are
``bound``'s: 48 B a live row in and out and the table at 3.35 TB/s,
operations at 67 TFLOP/s, the larger of the two.  At 13 rounds under
block2 a push is 121 operations.
"""

from __future__ import annotations

import bound

BORIS_OPS = 36     # a push, over the leapfrog's
PERIODIC_OPS = 15  # a push, over the bounds test
CHILD_OPS = 22     # an isotropic child's velocity


def ops_per_push(rounds: int, block2: bool) -> float:
    return bound.ops_per_push(rounds, block2) + BORIS_OPS + PERIODIC_OPS


def phase_bound_s(pushes: int, rows_in: int, rows_out: int, rounds: int,
                  block2: bool) -> float:
    """Seconds the H100 needs at least for one general mobility phase."""
    ops = (pushes * ops_per_push(rounds, block2)
           + CHILD_OPS * max(0, rows_out - rows_in))
    n_bytes = bound.RECORD_BYTES * (rows_in + rows_out) + bound.TABLE_BYTES
    return max(ops / bound.F32_OPS_PER_S, n_bytes / bound.HBM_BYTES_PER_S)
