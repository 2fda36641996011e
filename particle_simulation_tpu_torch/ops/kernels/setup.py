"""The set-up's seeding on the card: the wrapper of ``csrc/setup.cu``.

``setup_seed`` writes the six capacity-sized fields of an initial
``SimState`` in one launch: ids, positions and, with a thermal start,
velocities for the ``init_n`` live slots, zeros and ``STATUS_EMPTY`` for
the rest.  Its plain twin is ``state.seed_plain`` (the set-up as PyTorch
operations over every slot), which ``state.setup_particles`` takes for any
device other than the card; the two are bit for bit equal
(tests/test_torch_setup_kernel.py).  The source note in ``csrc/setup.cu``
says what bounds the kernel.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ...rng import MASK
from ...utils.profiling import span


def setup_seed(capacity: int, init_n: int, slot_offset: int, seed: int,
               affine: Sequence[Tuple[float, float]], vth: Optional[float],
               dtype: torch.dtype, device) -> Tuple[torch.Tensor, ...]:
    """(pos, vel, acc, status, id_hi, id_lo) of a state of ``capacity``
    slots on the CUDA ``device``, the first ``init_n`` live: ids keyed on
    the global index ``slot + slot_offset`` under ``seed``, each axis'
    position ``u01 * scale + shift`` with ``affine[axis]`` = (scale, shift)
    (``rng.affine``), and the velocity ``vth * N(0, 1)`` (``vth`` in the
    state's float type) or 0 where ``vth`` is None.  ``dtype`` is pos's
    and vel's type, float32 or float64."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no set-up kernel for device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no set-up kernel for {dtype}")
    if not 0 <= init_n <= capacity:
        raise ValueError(f"init_n {init_n} outside [0, capacity {capacity}]")
    from . import build

    fields = (
        torch.empty((capacity, 3), dtype=dtype, device=device),
        torch.empty((capacity, 3), dtype=dtype, device=device),
        torch.empty((capacity, 3), dtype=torch.float32, device=device),
        *(torch.empty((capacity,), dtype=torch.int32, device=device)
          for _ in range(3)),
    )
    if capacity:
        lib = build.load()
        (sx, lx), (sy, ly), (sz, lz) = affine
        with span("pst.setup.launch"):
            lib.call(
                "pst_setup_seed", *(f.data_ptr() for f in fields), capacity,
                init_n, slot_offset, int(seed) & MASK, lx, ly, lz, sx, sy, sz,
                0.0 if vth is None else vth, vth is not None,
                dtype == torch.float64,
                torch.cuda.current_stream(device).cuda_stream,
            )
        setup_seed.launches += 1
    return fields


setup_seed.launches = 0
