"""The pieces of ``particle_simulation_tpu/ops/pallas/push_mcc.py`` that the
work-log engine shares: the record field order, the phase-internal status
encodings and the outcome of the cross-section lookup.

The encodings are the single source of truth for the CUDA kernel too:
``build.py`` passes them to ``nvcc`` as macros (``kernel_defines``).

The TPU lookup ``make_chunked_lookup`` (its chunk-swept lane gathers, the
threshold and polynomial modes and the timing probes) exists because the
TPU has no per-lane gather from an 80 KB table.  Every exact mode of it
returns the outcomes of a direct ``table[energy_to_index(E)]`` read, and
that read is what is ported (``table_lookup`` here, ``csrc/lookup.cuh`` in
the kernel).
"""

from __future__ import annotations

import torch

from ...cross_section import energy_to_index

FIELD_NAMES = (
    "px", "py", "pz", "vx", "vy", "vz", "ax", "ay", "az",
    "status", "id_hi", "id_lo",
)
NF = len(FIELD_NAMES)

_INF_START = 0x7FFFFFF

# unfinished: -1 | s>0 | suspended (<= _SUS_BASE, packs resume step + stamp)
_SUS_BASE = -40000
_STAMP_BITS = 15
_STAMP_MASK = (1 << _STAMP_BITS) - 1


def _encode_suspended(resume, stamp):
    return _SUS_BASE - (((resume - 1) << _STAMP_BITS) | (stamp + 2))


def _is_suspended(s):
    return s <= _SUS_BASE


def _suspended_resume(s):
    return ((_SUS_BASE - s) >> _STAMP_BITS) + 1


def _suspended_stamp(s):
    return ((_SUS_BASE - s) & _STAMP_MASK) - 2


def _is_unfinished(s):
    return (s == -1) | (s > 0) | _is_suspended(s)


def kernel_defines() -> list:
    """The encodings as ``nvcc`` macro definitions."""
    return [
        f"-DPST_SUS_BASE={_SUS_BASE}",
        f"-DPST_STAMP_BITS={_STAMP_BITS}",
        f"-DPST_INF_START={_INF_START}",
    ]


def table_lookup(table: torch.Tensor, energy: torch.Tensor):
    """(split, remove) chances of each energy's bucket."""
    row = table[energy_to_index(energy).long()]
    return row[..., 0], row[..., 1]
