"""Sim time vs Poisson step count (reference analyse/plot_poisson_steps.py).

    python -m particle_simulation_tpu_torch.analyse.plot_poisson_steps

Arguments: [CSV [OUT]]; the CSV defaults to the port's sweep CSV, the
plot to ``out/torch/plots/time_vs_poisson_steps.png``.
"""
import sys

from .common import csv_plot_main


def main(argv=()):
    return csv_plot_main(list(argv), x="iterations", y="time",
                         out_name="time_vs_poisson_steps.png",
                         title="Sim time vs Poisson steps",
                         logy=False)


if __name__ == "__main__":
    main(sys.argv[1:])
