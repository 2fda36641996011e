"""Simulation state: fixed-capacity structure-of-arrays particle storage
(counterpart of ``particle_simulation_tpu/state.py``).

The fields are those of the JAX ``SimState``; ``pos`` and ``vel`` are
float64 under ``precision="f64"`` (``config.float_dtype``) and ``acc`` is
float32 either way.  Two differences of
representation: the genealogy ids are stored as int32 bit patterns (torch
has no usable uint32 on the CPU; rng.py explains), and ``n`` is a Python
int, since the host reads the population after every Poisson step anyway.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .config import SimConfig, float_dtype
from .constants import STATUS_ALIVE, STATUS_EMPTY
from .device import resolve
from .ops.kernels import setup as setup_kernel
from .utils.profiling import span


class SimState(NamedTuple):
    pos: torch.Tensor     # (C, 3) f32/f64 — metres
    vel: torch.Tensor     # (C, 3) f32/f64 — m/s
    acc: torch.Tensor     # (C, 3) f32 — m/s^2, frozen during a Poisson step
    status: torch.Tensor  # (C,) i32 — constants.py status protocol
    id_hi: torch.Tensor   # (C,) i32 bit pattern of the u32 id word
    id_lo: torch.Tensor   # (C,) i32
    n: int                # created-slot count (may exceed C on overflow)

    @property
    def capacity(self) -> int:
        return self.status.shape[0]

    @property
    def n_clamped(self) -> int:
        return min(self.n, self.capacity)

    @property
    def device(self) -> torch.device:
        return self.status.device


def zero_state(config: SimConfig, device=None) -> SimState:
    """An empty state on ``device`` (the card when None, device.resolve)."""
    device = resolve(device)
    c = config.capacity
    fdt = float_dtype(config)
    return SimState(
        pos=torch.zeros((c, 3), dtype=fdt, device=device),
        vel=torch.zeros((c, 3), dtype=fdt, device=device),
        acc=torch.zeros((c, 3), dtype=torch.float32, device=device),
        status=torch.full((c,), STATUS_EMPTY, dtype=torch.int32, device=device),
        id_hi=torch.zeros((c,), dtype=torch.int32, device=device),
        id_lo=torch.zeros((c,), dtype=torch.int32, device=device),
        n=0,
    )


def setup_particles(config: SimConfig, slot_offset: int = 0,
                    device=None) -> SimState:
    """Seed ``init_n`` electrons uniformly in the 62-cell cube at the domain
    centre (reference src/particle_move.cu:7-19), with zero velocity, or
    with ``init_vth * N(0, 1)`` per component when ``config.init_vth`` is
    set (the JAX package's thermal start, rng.setup_gaussian).  The draws
    are float32; under ``precision="f64"`` they are widened exactly and
    ``init_vth`` multiplies in float64, as in the JAX package.

    ``slot_offset`` shifts the global particle index that keys the ids, as
    the JAX package's sharded setup uses it.  ``device`` is the card when
    None (device.resolve).  A CUDA device runs the set-up kernel
    (``ops.kernels.setup``: one launch), any other the plain twin
    ``seed_plain``; the two give the same state bit for bit."""
    c, init_n = config.capacity, config.init_n
    if init_n > c:
        raise ValueError(f"init_n {init_n} exceeds capacity {c}")
    device = resolve(device)
    with span("pst.setup"):
        if device.type != "cuda":
            return seed_plain(config, slot_offset, device)
        fields = setup_kernel.setup_seed(
            c, init_n, slot_offset, config.seed,
            [rng.affine(*seed_box(config, ax)) for ax in range(3)],
            thermal_vth(config), float_dtype(config), device)
        return SimState(*fields, n=init_n)


def seed_box(config: SimConfig, axis: int):
    """(lo, hi) in metres of the seed cube along ``axis``: 62 cells about
    the centre, clamped to the domain for grids below 62 cells."""
    g = config.grid_size[axis]
    return (max(0, g // 2 - 30) * config.cell_size,
            min(g, g // 2 + 32) * config.cell_size)


def thermal_vth(config: SimConfig):
    """The thermal start's ``init_vth`` in the state's float type (float32
    values as Python floats), or None without one."""
    if not config.init_vth:
        return None
    if float_dtype(config) == torch.float64:
        return float(config.init_vth)
    return float(np.float32(config.init_vth))


def seed_plain(config: SimConfig, slot_offset: int, device) -> SimState:
    """``setup_particles``' work as PyTorch operations over every slot,
    each part in its span: the set-up kernel's plain twin."""
    c, init_n = config.capacity, config.init_n
    fdt = float_dtype(config)
    with span("pst.setup.zero"):
        st = zero_state(config, device)
    with span("pst.setup.ids"):
        slots = (torch.arange(c, dtype=torch.int64, device=device)
                 + slot_offset)
        id_hi, id_lo = rng.initial_ids(config.seed, slots & rng.MASK)

    with span("pst.setup.pos"):
        axes = [rng.setup_uniform(id_hi, id_lo, ax,
                                  *seed_box(config, ax)).to(fdt)
                for ax in range(3)]
        pos = torch.stack(axes, dim=1)

    vel = st.vel
    vth = thermal_vth(config)
    if vth is not None:
        with span("pst.setup.vel"):
            vel = torch.stack(
                [vth * rng.setup_gaussian(id_hi, id_lo, ax).to(fdt)
                 for ax in range(3)], dim=1)

    with span("pst.setup.select"):
        active = torch.arange(c, device=device) < init_n
        zero = torch.zeros((), dtype=torch.int32, device=device)
        if vth is not None:
            vel = torch.where(active[:, None], vel, torch.zeros_like(vel))
        return st._replace(
            pos=torch.where(active[:, None], pos, torch.zeros_like(pos)),
            vel=vel,
            status=torch.where(
                active, torch.tensor(STATUS_ALIVE, dtype=torch.int32,
                                     device=device), st.status
            ),
            id_hi=torch.where(active, rng.to_i32(id_hi), zero),
            id_lo=torch.where(active, rng.to_i32(id_lo), zero),
            n=init_n,
        )
