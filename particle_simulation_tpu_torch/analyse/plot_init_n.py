"""Sim time vs initial particle count (reference analyse/plot_pic_init_n.py).

    python -m particle_simulation_tpu_torch.analyse.plot_init_n

Arguments: [CSV [OUT]]; the CSV defaults to the port's sweep CSV, the
plot to ``out/torch/plots/time_vs_init_n.png``.
"""
import sys

from .common import csv_plot_main


def main(argv=()):
    return csv_plot_main(list(argv), x="init n", y="time",
                         out_name="time_vs_init_n.png",
                         title="Sim time vs init n",
                         logy=True)


if __name__ == "__main__":
    main(sys.argv[1:])
