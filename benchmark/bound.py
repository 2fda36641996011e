"""The least time an H100 could take for a mobility phase, and the
published peaks it is measured against.

Frozen here so that the yardstick does not move with the program: the
operation count is the one the port's smoke run uses for its engines
(``chip_smoke.py`` ``ops_per_push``, ``RECORD_BYTES``; the peaks of
``probes/common.py``).  It does not depend on which kernel does the work:

* operations = pushes x ``ops_per_push(rng_rounds, rng_mode == "block2")``;
* bytes = 48 B x (live rows in + live rows out) + the table;
* the bound is the larger of operations at 67 TFLOP/s and bytes at
  3.35 TB/s.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores; an FMA counts two

# operations of a lane-step (csrc/physics.cuh and threefry.cuh, an FMA
# counted as two and logf as one): the moves, lookup and draw outside the
# cipher (44), and a Threefry block of R rounds, 3 a round (add, rotate,
# xor), 3 a key injection every 4 rounds and 4 to set up the key schedule
# and the first injection
LANE_STEP_OPS = 44
THREEFRY_ROUND_OPS, THREEFRY_INJECTION_OPS, THREEFRY_SETUP_OPS = 3, 3, 4
# a particle: pos, vel, acc (3 x 12 B) and status, id_hi, id_lo (3 x 4 B)
RECORD_BYTES = 48
TABLE_BYTES = 10000 * 2 * 4


def ops_per_push(rounds: int, block2: bool) -> float:
    """Operations a lane-step does at ``rounds`` Threefry rounds; under
    block2 two steps share a block."""
    block = (THREEFRY_ROUND_OPS * rounds
             + THREEFRY_INJECTION_OPS * (rounds // 4) + THREEFRY_SETUP_OPS)
    return LANE_STEP_OPS + block / (2 if block2 else 1)


def phase_bound_s(pushes: int, rows_in: int, rows_out: int, rounds: int,
                  block2: bool) -> float:
    """Seconds the H100 needs at least for one mobility phase."""
    ops = pushes * ops_per_push(rounds, block2)
    n_bytes = RECORD_BYTES * (rows_in + rows_out) + TABLE_BYTES
    return max(ops / F32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
