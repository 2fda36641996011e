"""Final population vs mobility steps (reference
analyse/plot_pic_particles_added.py).

    python -m particle_simulation_tpu_torch.analyse.plot_particles_added

Arguments: [CSV [OUT]]; the CSV defaults to the port's sweep CSV, the
plot to ``out/torch/plots/final_n_vs_mobility.png``.
"""
import sys

from .common import csv_plot_main


def main(argv=()):
    return csv_plot_main(list(argv), x="mobility steps", y="final n",
                         out_name="final_n_vs_mobility.png",
                         title="Final particle count vs mobility steps",
                         logy=True)


if __name__ == "__main__":
    main(sys.argv[1:])
