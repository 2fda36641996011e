"""Sim time vs kernel tile height per fused engine (counterpart of the JAX
package's plot_tile; the reference's block-size plot,
analyse/plot_pic_block.py).  Reads a sweep CSV whose ``block size``
column carries the tile, as the JAX package's kernel-tile sweep does.

    python -m particle_simulation_tpu_torch.analyse.plot_tile

Arguments: [CSV [OUT]]; the CSV defaults to the JAX package's
``out/data/kernel_tile_sweep.csv`` (read only), the plot to
``out/torch/plots/time_vs_tile.png``.
"""
import os
import sys

from .common import PLOTS, lineplot, load_runs

DEFAULT_TILE_CSV = "out/data/kernel_tile_sweep.csv"


def main(argv=()):
    argv = list(argv)
    df = load_runs(argv[0] if argv else DEFAULT_TILE_CSV)
    out = argv[1] if len(argv) > 1 else os.path.join(PLOTS, "time_vs_tile.png")
    # one line per (engine, T): the reference's block plot holds the other
    # sweep axes fixed per line
    df = df.assign(
        series=df["func"] + " T=" + df["mobility steps"].astype(str))
    lineplot(df, "block size", "time", "series", out,
             title="Sim time vs kernel tile height",
                         logy=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
