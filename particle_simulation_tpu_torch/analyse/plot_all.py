"""Exploration plot over every timing CSV of a folder (counterpart of the
JAX package's plot_all; reference analyse/plot.py: concatenated CSVs, a
time-vs-steps panel per scheduler).

    python -m particle_simulation_tpu_torch.analyse.plot_all [prefix]

Reads ``out/data/<prefix>*.csv`` with the timing schema
(``observability.CSV_HEADER``; read only) and writes
``out/torch/plots/overview.png``.
"""

from __future__ import annotations

import os
import sys

from .common import PLOTS, pyplot, save_figure


def load_all(prefix: str = "", data_dir: str = "out/data"):
    """Every CSV of ``data_dir`` starting with ``prefix`` that has the
    timing columns, concatenated, with its file name in ``source``."""
    import pandas as pd

    frames = []
    for f in sorted(os.listdir(data_dir)):
        if not f.endswith(".csv") or not f.startswith(prefix):
            continue
        try:
            df = pd.read_csv(os.path.join(data_dir, f))
        except Exception:
            continue
        df.columns = [c.strip() for c in df.columns]
        if {"func", "mobility steps", "time"} <= set(df.columns):
            df["source"] = f
            frames.append(df)
    if not frames:
        raise SystemExit(
            f"no timing CSVs under {data_dir!r} (prefix={prefix!r})")
    return pd.concat(frames, ignore_index=True).dropna(subset=["time"])


def plot(df, out_path: str = os.path.join(PLOTS, "overview.png")):
    funcs = sorted(df["func"].unique())
    fig, axes = pyplot().subplots(1, len(funcs), figsize=(5 * len(funcs), 4),
                                  sharey=True, squeeze=False)
    for ax, func in zip(axes[0], funcs):
        sub = df[df["func"] == func]
        for src, grp in sub.groupby("source"):
            grp = grp.sort_values("mobility steps")
            ax.plot(grp["mobility steps"], grp["time"], marker="o",
                    label=src, alpha=0.8)
        ax.set_title(func)
        ax.set_xlabel("mobility steps")
        ax.set_yscale("log")
        ax.grid(True, alpha=0.3)
    axes[0][0].set_ylabel("time (ms, log)")
    axes[0][-1].legend(fontsize=7)
    save_figure(fig, out_path)


if __name__ == "__main__":
    plot(load_all(sys.argv[1] if len(sys.argv) > 1 else ""))
