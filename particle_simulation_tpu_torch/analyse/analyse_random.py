"""Uniformity of the collision draws (counterpart of the JAX package's
analyse_random; reference analyse/analyse_random.py): the step-1 draws of
100k seeded particles in 20 bins, and the chi-square of the flatness.

    python -m particle_simulation_tpu_torch.analyse.analyse_random \\
        [out.png] [--device cpu]

The draws are made on the card unless ``--device cpu``; the plot goes to
``out/torch/plots/random_hist.png``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import rng
from ..device import resolve
from .common import PLOTS, pyplot, save_figure

SEED = 39587


def histogram(n: int = 100_000, seed: int = SEED, device=None):
    """(counts, edges) of the collision draws in [0, 100) of particles
    0..n-1 at Poisson step 0, mobility step 1 (``rng.step_draws``)."""
    device = resolve(device)
    hi, lo = rng.initial_ids(seed, torch.arange(n, device=device))
    u = rng.step_draws(seed, hi, lo, 0, 1, 0.0, 100.0)[0]
    return np.histogram(u.cpu().numpy(), bins=20, range=(0, 100))


def main(out_path: str = os.path.join(PLOTS, "random_hist.png"),
         device=None) -> float:
    """Plot the histogram; print and return the chi-square."""
    hist, edges = histogram(device=device)
    fig, ax = pyplot().subplots()
    ax.bar(edges[:-1], hist, width=5, align="edge")
    ax.set_title("collision-draw uniformity (100k particles)")
    save_figure(fig, out_path)
    chi2 = float(((hist - hist.mean()) ** 2 / hist.mean()).sum())
    print("chi^2 flatness:", chi2)
    return chi2


if __name__ == "__main__":
    args = list(sys.argv[1:])
    dev = None
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    main(*args, device=dev)
