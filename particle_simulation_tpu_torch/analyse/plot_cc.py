"""Collision-chance sweep and plot (counterpart of the JAX package's
plot_cc; reference analyse/plot_pic_cc.py): constant tables, time against
the collision chance per scheduler, log-log.

    python -m particle_simulation_tpu_torch.analyse.plot_cc \\
        [--run] [--device cpu] [csv] [out.png]

``--run`` runs the sweep first through ``runtime.run_pic`` (on the card
unless ``--device cpu``) and appends its rows to the CSV, by default
``out/torch/data/pic_cc.csv``; the plot goes to
``out/torch/plots/time_vs_cc.png``.  The JAX package's ``auto_bucket``
(the TPU's capacity ladder) has no counterpart here.
"""

from __future__ import annotations

import os
import sys

import torch

from ..config import SimConfig
from ..cross_section import N_STEPS
from ..device import resolve
from .common import DATA, PLOTS, pyplot, save_figure

CC_CSV = os.path.join(DATA, "pic_cc.csv")
CC_PNG = os.path.join(PLOTS, "time_vs_cc.png")
CC_HEADER = (
    "func,init n,iterations,mobility steps,block size,sleep time,"
    "collision chance,final n,time"
)
CHANCES = (0.02, 0.1, 0.5, 2.0, 10.0, 50.0)
SCHEDULERS = ("dynamic", "sync", "naive", "dynamic_old")
# the JAX package's sweep point
SWEEP = SimConfig(init_n=20_000, capacity=1_000_000, poisson_steps=3,
                  poisson_timestep=20, grid_size=(64, 64, 64))


def run_cc_sweep(chances=CHANCES, schedulers=SCHEDULERS,
                 out_csv: str = CC_CSV, base: SimConfig = SWEEP,
                 device=None) -> str:
    """Constant tables with split = remove = cc/2 percent (cc the total
    per-step collision chance in percent, as in the reference's stress
    table); one untimed one-step run per row first (the kernels' build
    and the card's first launches), then the timed run."""
    from ..runtime import run_pic

    device = resolve(device)
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    new = not os.path.exists(out_csv)
    with open(out_csv, "a") as f:
        if new:
            f.write(CC_HEADER + "\n")
        for cc in chances:
            table = torch.full((N_STEPS, 2), cc / 2, dtype=torch.float32,
                               device=device)
            for sched in schedulers:
                cfg = base.replace(scheduler=sched)
                run_pic(cfg.replace(poisson_steps=1), table=table,
                        print_header=False, device=device)
                run = run_pic(cfg, table=table, print_header=False,
                              device=device)
                f.write(
                    f"{run.function},{cfg.init_n},{cfg.poisson_steps},"
                    f"{cfg.poisson_timestep},{cfg.block_size},"
                    f"{cfg.sleep_time_ns},{cc},{run.final_n},"
                    f"{run.device_time_ms}\n")
                f.flush()
                print(f"cc={cc:6.2f} {sched:12s} final_n={run.final_n:8d} "
                      f"time={run.device_time_ms:9.1f} ms", flush=True)
    return out_csv


def plot(csv_path: str = CC_CSV, out_path: str = CC_PNG) -> None:
    import pandas as pd

    df = pd.read_csv(csv_path)
    df.columns = [c.strip() for c in df.columns]
    fig, ax = pyplot().subplots(figsize=(8, 5))
    for func, grp in df.groupby("func"):
        grp = grp.sort_values("collision chance")
        ax.plot(grp["collision chance"], grp["time"], marker="o", label=func)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("Collision Chance (log scale)")
    ax.set_ylabel("Time (ms) (log scale)")
    ax.set_title("Collision Chance vs. Time Across Schedulers")
    ax.legend(title="Function")
    ax.grid(True, alpha=0.3)
    save_figure(fig, out_path)


def main(argv=(), base: SimConfig = SWEEP) -> str:
    """The command line above; ``base`` is the sweep's configuration."""
    args = list(argv)
    run = "--run" in args
    device = None
    if run:
        args.remove("--run")
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    csv = args[0] if args else CC_CSV
    out = args[1] if len(args) > 1 else CC_PNG
    if run:
        run_cc_sweep(out_csv=csv, base=base, device=device)
    plot(csv, out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
