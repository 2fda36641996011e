"""External-validation plot (counterpart of the JAX package's
plot_validation): the population under constant collision tables against
the analytic branching-process mean with +-3 sigma bands.

Each mobility step is one Galton-Watson branching step per particle
(split -> 2, remove -> 0, else 1 at the table's chances; children join
the next step, reference src/particle_move.cu:62-74), so E[n] and Var[n]
after N steps are closed-form (``branching_moments``).  The solid lines
are ``naive`` runs of the port, on the card unless ``--device cpu``.

    python -m particle_simulation_tpu_torch.analyse.plot_validation \\
        [out.png] [--device cpu]

The plot goes to ``out/torch/plots/validation_growth.png`` by default.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile

import numpy as np

from .common import PLOTS, pyplot, save_figure

TABLES = (((50.0, 50.0), "tab:blue"), ((2.0, 1.0), "tab:orange"),
          ((1.0, 2.0), "tab:green"))


def branching_moments(n0, split_pct, remove_pct, n_steps):
    """Analytic (mean, variance) of the population after ``n_steps``
    mobility steps of the constant-table branching process: offspring 2
    with p_s, 0 with p_r, 1 otherwise; m = 1 + p_s - p_r and
    sigma^2 = 4 p_s + (1 - p_s - p_r) - m^2."""
    p_s, p_r = split_pct / 100.0, remove_pct / 100.0
    m = 1.0 + p_s - p_r
    var1 = 4.0 * p_s + (1.0 - p_s - p_r) - m * m
    mean = n0 * m**n_steps
    if abs(m - 1.0) < 1e-12:
        var = var1 * n_steps * n0
    else:
        var = var1 * m ** (n_steps - 1) * (m**n_steps - 1.0) / (m - 1.0) * n0
    return mean, var


def main(out_path: str = os.path.join(PLOTS, "validation_growth.png"),
         device=None, n0: int = 20_000, t_steps: int = 10,
         k_steps: int = 6, capacity: int = 1 << 17) -> dict:
    """Run, plot and return {(split, remove): measured populations}."""
    from .. import SimConfig
    from ..cross_section import N_STEPS, write_table
    from ..runtime import run_pic

    fig, ax = pyplot().subplots(figsize=(7, 4.5))
    xs = np.arange(k_steps + 1) * t_steps
    measured_all = {}
    for (s_pct, r_pct), color in TABLES:
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "t.txt")
            write_table(path, np.full((N_STEPS, 2), 0.0, np.float32)
                        + np.asarray([s_pct, r_pct], np.float32))
            cfg = SimConfig(
                init_n=n0, capacity=capacity, poisson_steps=k_steps,
                poisson_timestep=t_steps, grid_size=(32, 32, 32),
                scheduler="naive", cross_section_path=path,
            )
            run = run_pic(cfg, print_header=False, device=device)
        measured = [n0] + [s.n for s in run.steps]
        measured_all[(s_pct, r_pct)] = measured
        mean, lo, hi = [n0], [n0], [n0]
        for x in xs[1:]:
            m, v = branching_moments(n0, s_pct, r_pct, int(x))
            mean.append(m)
            lo.append(m - 3 * math.sqrt(v))
            hi.append(m + 3 * math.sqrt(v))
        ax.fill_between(xs, lo, hi, color=color, alpha=0.18,
                        label=f"analytic {s_pct:g}/{r_pct:g} ±3σ")
        ax.plot(xs, mean, color=color, lw=0.8, ls="--")
        ax.plot(xs[:len(measured)], measured, color=color, lw=1.6,
                marker="o", ms=3, label=f"measured {s_pct:g}/{r_pct:g}")
    ax.set_xlabel("mobility steps")
    ax.set_ylabel("population n")
    ax.set_title("End-to-end growth vs analytic branching process "
                 "(constant tables)")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.25)
    save_figure(fig, out_path, dpi=130)
    return measured_all


if __name__ == "__main__":
    args = list(sys.argv[1:])
    dev = None
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    main(*args, device=dev)
