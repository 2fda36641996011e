"""Cross-section (collision chance) tables (counterpart of
``particle_simulation_tpu/cross_section.py``).

The bundled tables are read by file path from the JAX package's data folder
(``particle_simulation_tpu/data``) without importing that package.  A table
is a (N_STEPS, 2) float32 tensor of (split, remove) chances in percent; it is
the only "weight" of this system.  ``physical_table`` and
``argon_like_table`` build one from cross sections (numpy, bitwise the JAX
package's tables) and ``write_table`` stores it in the reference's format.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .device import resolve
from .fma import elementary, fma, fma_f32
from .utils import fastio

N_STEPS = 10000

_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "particle_simulation_tpu", "data",
)
_BUNDLED = os.path.join(_DATA, "cross_section.txt")
_BUNDLED_CONST = os.path.join(_DATA, "cross_section_const.txt")
# the port's own data folder, which ensure_bundled_tables writes
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# jnp.log10(x) lowers to log(x) * float32(1/ln 10); the bucket scale is
# float32(N_STEPS / 22)
LOG10_E = np.float32(0.4342944920063019)
BUCKET_SCALE = np.float32(N_STEPS / 22.0)
# the same two constants in float64 (precision="f64")
LOG10_E_F64 = 1.0 / math.log(10.0)
BUCKET_SCALE_F64 = N_STEPS / 22.0


def bundled_paths() -> tuple[str, str]:
    """(sine-modulated demo table, constant 50/50 stress table)."""
    return _BUNDLED, _BUNDLED_CONST


def generate_table(n_steps: int = N_STEPS) -> np.ndarray:
    """The sine-modulated demo table (reference cross_section_gen.py:3-10)."""
    i = np.arange(n_steps, dtype=np.float64)
    val = (np.sin(np.power(i, 2.6) / 50_000_000.0) + 1.01) * np.power(i, 0.1)
    return np.stack([val, val], axis=1).astype(np.float32)


def write_table(path: str, table: np.ndarray) -> None:
    """Write (split, remove) pairs in the reference's text format, as the
    JAX package writes them (``float`` repr, one pair a line)."""
    with open(path, "w") as f:
        for split, remove in table:
            f.write(f"{float(split)} {float(remove)}\n")


def physical_table(sigma_split, sigma_remove, gas_density: float,
                   dt: float, n_steps: int = N_STEPS) -> np.ndarray:
    """A collision table from physical cross sections (m^2) as functions of
    the energy variable E = |v|^2: the per-step chance
    ``1 - exp(-n_gas * sigma(E) * |v| * dt)`` in percent at each bucket's
    centre energy, computed in float64 and stored as float32, operation
    for operation the JAX package's."""
    i = np.arange(n_steps, dtype=np.float64) + 0.5
    log10_e = i * (22.0 / n_steps) - 6.0
    energy = np.power(10.0, log10_e)
    speed = np.sqrt(energy)
    p_split = 1.0 - np.exp(-gas_density * sigma_split(energy) * speed * dt)
    p_remove = 1.0 - np.exp(-gas_density * sigma_remove(energy) * speed * dt)
    table = np.stack([p_split * 100.0, p_remove * 100.0], axis=1)
    return np.clip(table, 0.0, 100.0).astype(np.float32)


def argon_like_table(gas_density: float = 1e20, dt: float = 1e-9,
                     n_steps: int = N_STEPS) -> np.ndarray:
    """The JAX package's argon-like table: Lotz-form ionisation above the
    threshold |v|^2 = 5.54e12 (15.76 eV for an electron), peaking near 4x
    the threshold and falling as 1/E, plus a low-energy absorption tail.
    Synthetic constants with argon's shape; ``gas_density`` (m^-3) and
    ``dt`` (the mobility step, s) set the per-step chances."""
    e_ion = 5.54e12

    def sigma_ion(e):
        x = np.maximum(e / e_ion, 1.0)
        return np.where(e > e_ion, 2.5e-20 * np.log(x) / x, 0.0)

    def sigma_abs(e):
        return 1.0e-21 / (1.0 + e / 1e11)

    return physical_table(sigma_ion, sigma_abs, gas_density, dt,
                          n_steps=n_steps)


def ensure_bundled_tables(data_dir: str = DATA) -> tuple[str, str]:
    """Write the two bundled tables (``generate_table`` and the constant
    50/50 table) into ``data_dir`` where they are missing, in the JAX
    package's format; returns their paths (sine, const)."""
    paths = tuple(os.path.join(data_dir, os.path.basename(p))
                  for p in (_BUNDLED, _BUNDLED_CONST))
    os.makedirs(data_dir, exist_ok=True)
    tables = (generate_table, lambda: np.full((N_STEPS, 2), 50.0, np.float32))
    for path, make in zip(paths, tables):
        if not os.path.exists(path):
            write_table(path, make())
    return paths


def load_table(path: str = "", device=None) -> torch.Tensor:
    """Load (split_chance, remove_chance) pairs -> (N_STEPS, 2) float32 on
    ``device`` (the card when None, device.resolve), parsed by the port's
    IO library (``utils/fastio.py``).

    A missing, short or malformed file raises (reference
    src/cross_section.cu:17-21 prints and continues with garbage)."""
    device = resolve(device)
    if not path:
        path = _BUNDLED
    data = fastio.parse_float_pairs(path, N_STEPS).astype(np.float32)
    return torch.from_numpy(data).to(device)


def energy_to_index(energy: torch.Tensor) -> torch.Tensor:
    """trunc((log10(E) + 6) * N_STEPS / 22) clamped to [0, N_STEPS-1]
    (reference src/cross_section.cu:32-35), as int32.

    ``log10(E) + 6`` is one fused multiply-add, as XLA computes it (fma.py).
    ``torch.log`` and XLA:CPU's ``log`` differ on rare float32 inputs, so a
    bucket can differ by one near a bucket edge (tests/test_torch_lookup.py
    states the bound).  A float64 energy (``precision="f64"``) is indexed
    in float64 throughout, as JAX under ``jax_enable_x64`` does."""
    if energy.dtype == torch.float64:
        x = fma(elementary("log", energy), LOG10_E_F64, 6.0)
        idx = torch.trunc(x * BUCKET_SCALE_F64)
        idx = torch.where(torch.isnan(idx), torch.zeros_like(idx), idx)
        return torch.clamp(idx, 0, N_STEPS - 1).to(torch.int32)
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
