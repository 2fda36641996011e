"""Checkpoint / resume (counterpart of ``particle_simulation_tpu/checkpoint.py``,
its npz half).

The reference has none (SURVEY.md §5.4).  A snapshot is one npz file,
``step_NNNNNN.npz`` in a checkpoint directory, holding the state in the
JAX package's types (``interop.state_to_numpy``: ids as uint32, ``n`` as a
0-d array) and the Poisson step it was taken at, so a checkpoint written by
either package resumes in the other.  The JAX package's orbax backend is
not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import interop
from .config import SimConfig, float_dtype
from .state import SimState


def save_npz(path: str, state: SimState, poisson_step: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, poisson_step=np.int64(poisson_step),
                        **interop.state_to_numpy(state))


def load_npz(path: str, device=None,
             dtype: torch.dtype = torch.float32) -> Tuple[SimState, int]:
    """(state on ``device``, the card when None; its Poisson step).  The
    positions and velocities are converted by value to ``dtype``
    (``interop.state_from_numpy``), whatever type the file holds."""
    with np.load(path) as z:
        state = interop.state_from_numpy(
            {f: z[f] for f in interop.FIELDS}, device, dtype)
        return state, int(z["poisson_step"])


def _npz_path(ckpt_dir: str, poisson_step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{poisson_step:06d}.npz")


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step of the ``step_NNNNNN.npz`` files in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        stem = name[len("step_"):-len(".npz")]
        if (name.startswith("step_") and name.endswith(".npz")
                and stem.isdigit()):
            steps.append(int(stem))
    return max(steps) if steps else None


def make_checkpoint_hook(config: SimConfig, ckpt_dir: str):
    """An ``on_step`` hook for run_pic that saves every state it is given,
    on the verbose cadence like the reference's log()."""
    del config

    def on_step(t, state):
        save_npz(_npz_path(ckpt_dir, t), state, t)

    return on_step


def resume_run(config: SimConfig, ckpt_dir: str, device=None):
    """Restore the latest checkpoint onto ``device`` (the card when None),
    its floats in the config's type (``float_dtype``), and run the rest of
    ``config.poisson_steps`` from there."""
    from .runtime import run_pic

    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    state, _ = load_npz(_npz_path(ckpt_dir, step), device,
                        float_dtype(config))
    remaining = config.poisson_steps - step
    if remaining <= 0:
        raise ValueError(f"checkpoint step {step} is beyond the configured run")
    # every draw is keyed by the absolute Poisson index, so resuming with
    # first_poisson_index=step reproduces the uninterrupted run exactly
    return run_pic(
        config.replace(poisson_steps=remaining),
        print_header=False,
        initial_state=state,
        first_poisson_index=step,
        device=device,
    )
