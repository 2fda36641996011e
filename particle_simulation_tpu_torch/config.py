"""Runtime configuration (counterpart of ``particle_simulation_tpu/config.py``).

``SimConfig`` keeps every field name and default of the JAX package's, so a
config can be written once and handed to both packages.  The fields fall in
three groups here:

* run shape and physics (init_n ... cross_section_path, spawn_depth,
  rng_rounds, rng_mode, worklog_rows) and the field path (bbox_subgrid:
  the S^3 subgrid edge, 0 for the full grid; ``check_supported`` requires
  0 or a positive multiple of 8): honoured;
* the model menu (integrator, collision_model, boundary, field_model,
  init_vth, b_field): every value the JAX package runs is honoured, by the
  plain schedulers and both CUDA engines; ``check_supported`` raises on an
  unknown value;
* ``precision``: "f32", or "f64", the JAX package's float64 oracle mode
  (positions and velocities in float64, ``float_dtype``), which the plain
  schedulers ``naive`` and ``sync`` run on either device and the engines
  refuse, as the JAX package's do;
* tuning knobs of the TPU kernels (lookup_*, kernel_*, worklog_unroll,
  worklog_horizon, worklog_align, worklog_start_buckets,
  worklog_spawn_guard, append_window, grid_mode; and bbox_hist_lanes,
  grid_live_chunks, full_deposit, which choose the MXU factorization of
  the subgrid histogram, the skipping of dead chunks (the port works on
  [0, n) already) and ``deposit_sorted``): accepted and ignored.  None of
  them changes the physics; they chose among TPU code paths with
  identical results.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from . import constants


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # ---- run shape (the reference's 8-arg CLI contract) ----
    init_n: int = 10_000
    capacity: int = 100_000
    poisson_steps: int = 20
    poisson_timestep: int = 10
    scheduler: str = "naive"
    verbose: int = 0
    block_size: int = 256
    sleep_time_ns: int = 0

    # ---- physics / domain ----
    grid_size: Tuple[int, int, int] = constants.DEFAULT_GRID_SIZE
    cell_size: float = constants.DEFAULT_CELL_SIZE
    mobility_dt: float = constants.DEFAULT_MOBILITY_DT
    seed: int = constants.DEFAULT_SEED
    cross_section_path: str = ""

    # ---- engine knobs ----
    spawn_depth: int = 2
    precision: str = "f32"
    kernel_loop: str = "while"
    kernel_sublanes: int = 128
    rng_rounds: int = 13
    rng_mode: str = "block2"
    worklog_unroll: int = 4
    append_window: int = 0
    worklog_rows: int = 0
    worklog_start_buckets: int = 1
    worklog_horizon: int = 0
    worklog_align: bool = False
    lookup_mode: str = "polythresh"
    lookup_static_chunks: int = 8
    lookup_poly_degree: int = 2
    lookup_cand_gate: bool = True
    lookup_poly_pack: bool = True
    lookup_margin_fold: bool = False
    lookup_poly_err_cap: float = 60000.0
    lookup_poly_fit: str = "lsq"
    lookup_tail_waves: int = 0
    lookup_hits: bool = False
    worklog_spawn_guard: bool = False
    integrator: str = "leapfrog"
    collision_model: str = "reverse"
    b_field: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    boundary: str = "absorb"
    init_vth: float = 0.0
    field_model: str = "neighbour"
    bbox_subgrid: int = 64
    bbox_hist_lanes: int = 256
    grid_live_chunks: int = 0
    full_deposit: str = "scatter"
    grid_mode: str = "replicated"

    @property
    def sim_size(self) -> Tuple[float, float, float]:
        return tuple(g * self.cell_size for g in self.grid_size)

    @property
    def electric_force_constant(self) -> float:
        return constants.electric_force_constant(self.cell_size)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


SCHEDULER_MODES = {
    # reference CLI mode string -> scheduler name (src/main.cu:26-40)
    "30": "dynamic",
    "31": "sync",
    "32": "naive",
    "33": "dynamic_old",
}

# model knob -> the values the port runs (the JAX package's model menu)
MODEL_VALUES = {
    "integrator": ("leapfrog", "boris"),
    "collision_model": ("reverse", "isotropic"),
    "boundary": ("absorb", "periodic"),
    "field_model": ("neighbour", "fft"),
}


# the engines that run float32 only: scheduler -> the engine's name
F32_ENGINES = {"dynamic": "work-log", "dynamic_old": "staged"}


def f32_only(engine: str) -> str:
    """The JAX package's message for a float64 state given to a fused
    engine."""
    return (f"the fused {engine} engine is f32-only; use scheduler='sync' "
            "or 'naive' for f64 oracle runs")


def float_dtype(config: SimConfig) -> torch.dtype:
    """The type of the positions and velocities: float64 under
    ``precision="f64"``, else float32 (the acceleration is always
    float32)."""
    return torch.float64 if config.precision == "f64" else torch.float32


def check_supported(config: SimConfig) -> None:
    """Raise ValueError for any model selection the port does not run, and
    for values the engines cannot represent."""
    for name, values in MODEL_VALUES.items():
        if getattr(config, name) not in values:
            raise ValueError(
                f"unknown {name}={getattr(config, name)!r} (one of {values})"
            )
    if config.precision not in ("f32", "f64"):
        raise ValueError(
            f"unknown precision={config.precision!r} (one of 'f32', 'f64')"
        )
    if config.precision == "f64" and config.scheduler in F32_ENGINES:
        raise ValueError(f32_only(F32_ENGINES[config.scheduler]))
    if not math.isfinite(config.init_vth):
        raise ValueError(f"init_vth={config.init_vth!r} must be finite")
    if (len(config.b_field) != 3
            or not all(math.isfinite(float(b)) for b in config.b_field)):
        raise ValueError(
            f"b_field={config.b_field!r} must be three finite floats"
        )
    if config.rng_mode not in ("perstep", "block2"):
        raise ValueError(f"unknown rng_mode {config.rng_mode!r}")
    # both engines pack (resume step, spawn stamp) into 15 bits each
    # (ops/kernels/push_mcc.py); larger step counts would alias
    if (config.scheduler in ("dynamic", "dynamic_old")
            and config.poisson_timestep + 2 >= (1 << 15)):
        raise ValueError(
            f"poisson_timestep={config.poisson_timestep} exceeds the fused "
            "engines' 15-bit stamp domain; use scheduler='naive' or 'sync'"
        )
    if config.spawn_depth < 1:
        raise ValueError(f"spawn_depth={config.spawn_depth} must be >= 1")
    # the subgrid's S^3 cells must fill (S^3/128, 128) rows (JAX grid.py:464)
    if config.bbox_subgrid < 0 or config.bbox_subgrid % 8:
        raise ValueError(
            f"bbox_subgrid={config.bbox_subgrid} must be 0 (full grid) or a "
            "positive multiple of 8"
        )
