"""Shared helpers of the analysis scripts (counterpart of
``particle_simulation_tpu/analyse/common.py``): pandas over the timing CSV
(``observability.CSV_HEADER``) and matplotlib line plots, written as PNGs
by ``observability.write_png`` (so ``read_png`` decodes them).

The default input is the port's own sweep CSV (``python -m
particle_simulation_tpu_torch bench`` writes it); the default outputs go
under ``out/torch/``, never over the JAX package's tracked ``out/plots``
or ``out/data`` files.
"""

from __future__ import annotations

import os

import numpy as np

from ..observability import write_png

DEFAULT_CSV = "out/data/mobility_timesteps_nodet_torch.csv"
PLOTS = "out/torch/plots"
DATA = "out/torch/data"


def load_runs(path: str = DEFAULT_CSV):
    """The rows of a timing CSV as a pandas DataFrame, header stripped."""
    import pandas as pd

    df = pd.read_csv(path, comment="#")
    df.columns = [c.strip() for c in df.columns]
    return df


def pyplot():
    """matplotlib's pyplot on the Agg backend (no display)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_figure(fig, out_path: str, dpi: int = 120) -> None:
    """Render ``fig`` and write it as an 8-bit RGB PNG; close it."""
    fig.set_dpi(dpi)
    fig.tight_layout()
    fig.canvas.draw()
    rgb = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_png(out_path, rgb)
    pyplot().close(fig)
    print(f"wrote {out_path}")


def lineplot(df, x, y, hue, out_path, title=None, logy=False):
    """Line plot with min/max bands over repeated measurements: duplicate
    (hue, x) rows aggregate to the median line and a shaded min..max band
    (reference analyse/plot.py:36)."""
    fig, ax = pyplot().subplots(figsize=(8, 5))
    for key, grp in df.groupby(hue):
        agg = (grp.groupby(x)[y].agg(["median", "min", "max"]).reset_index()
               .sort_values(x))
        line, = ax.plot(agg[x], agg["median"], marker="o", label=str(key))
        if (agg["max"] > agg["min"]).any():
            ax.fill_between(agg[x], agg["min"], agg["max"],
                            color=line.get_color(), alpha=0.2, linewidth=0)
    ax.set_xlabel(x)
    ax.set_ylabel(y)
    if logy:
        ax.set_yscale("log")
    if title:
        ax.set_title(title)
    ax.legend(title=hue)
    ax.grid(True, alpha=0.3)
    save_figure(fig, out_path)


def csv_plot_main(argv, x, y, out_name, title, logy, default=DEFAULT_CSV):
    """The body of the one-plot scripts: ``[csv] [out.png]``."""
    csv = argv[0] if argv else default
    out = argv[1] if len(argv) > 1 else os.path.join(PLOTS, out_name)
    lineplot(load_runs(csv), x, y, "func", out, title=title, logy=logy)
    return out
