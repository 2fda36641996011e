"""Cross-section (collision chance) tables (counterpart of
``particle_simulation_tpu/cross_section.py``).

The bundled tables are read by file path from the JAX package's data folder
(``particle_simulation_tpu/data``) without importing that package.  A table
is a (N_STEPS, 2) float32 tensor of (split, remove) chances in percent; it is
the only "weight" of this system.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .device import resolve
from .fma import fma_f32

N_STEPS = 10000

_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "particle_simulation_tpu", "data",
)
_BUNDLED = os.path.join(_DATA, "cross_section.txt")
_BUNDLED_CONST = os.path.join(_DATA, "cross_section_const.txt")

# jnp.log10(x) lowers to log(x) * float32(1/ln 10); the bucket scale is
# float32(N_STEPS / 22)
LOG10_E = np.float32(0.4342944920063019)
BUCKET_SCALE = np.float32(N_STEPS / 22.0)


def bundled_paths() -> tuple[str, str]:
    """(sine-modulated demo table, constant 50/50 stress table)."""
    return _BUNDLED, _BUNDLED_CONST


def generate_table(n_steps: int = N_STEPS) -> np.ndarray:
    """The sine-modulated demo table (reference cross_section_gen.py:3-10)."""
    i = np.arange(n_steps, dtype=np.float64)
    val = (np.sin(np.power(i, 2.6) / 50_000_000.0) + 1.01) * np.power(i, 0.1)
    return np.stack([val, val], axis=1).astype(np.float32)


def load_table(path: str = "", device=None) -> torch.Tensor:
    """Load (split_chance, remove_chance) pairs -> (N_STEPS, 2) float32 on
    ``device`` (the card when None, device.resolve).

    A missing or short file raises (reference src/cross_section.cu:17-21
    prints and continues with garbage)."""
    device = resolve(device)
    if not path:
        path = _BUNDLED
    data = np.loadtxt(path, dtype=np.float64, max_rows=N_STEPS)
    data = np.atleast_2d(np.asarray(data, dtype=np.float32))
    if data.shape != (N_STEPS, 2):
        raise ValueError(
            f"cross-section table {path!r} has shape {data.shape}, "
            f"expected ({N_STEPS}, 2)"
        )
    return torch.from_numpy(data).to(device)


def energy_to_index(energy: torch.Tensor) -> torch.Tensor:
    """trunc((log10(E) + 6) * N_STEPS / 22) clamped to [0, N_STEPS-1]
    (reference src/cross_section.cu:32-35), as int32.

    ``log10(E) + 6`` is one fused multiply-add, as XLA computes it (fma.py).
    ``torch.log`` and XLA:CPU's ``log`` differ on rare float32 inputs, so a
    bucket can differ by one near a bucket edge (tests/test_torch_lookup.py
    states the bound)."""
    x = fma_f32(torch.log(energy), float(LOG10_E), 6.0)
    idx = torch.trunc(x * torch.tensor(BUCKET_SCALE, device=energy.device))
    idx = torch.where(torch.isnan(idx), torch.zeros_like(idx), idx)
    return torch.clamp(idx, 0, N_STEPS - 1).to(torch.int32)


def table_lookup(table: torch.Tensor, energy: torch.Tensor):
    """(split, remove) chances of each energy's bucket: the outcome of the
    JAX package's lookup modes (ops/kernels/push_mcc.py says why only the
    outcome is ported), a direct ``table[energy_to_index(E)]`` read."""
    row = table[energy_to_index(energy).long()]
    return row[..., 0], row[..., 1]
