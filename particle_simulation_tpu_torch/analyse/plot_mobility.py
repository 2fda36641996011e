"""Sim time vs mobility steps per scheduler (reference
analyse/plot_pic_mobility.py).

    python -m particle_simulation_tpu_torch.analyse.plot_mobility

Arguments: [CSV [OUT]]; the CSV defaults to the port's sweep CSV, the
plot to ``out/torch/plots/time_vs_mobility.png``.
"""
import sys

from .common import csv_plot_main


def main(argv=()):
    return csv_plot_main(list(argv), x="mobility steps", y="time",
                         out_name="time_vs_mobility.png",
                         title="Sim time vs mobility steps",
                         logy=True)


if __name__ == "__main__":
    main(sys.argv[1:])
