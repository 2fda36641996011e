"""The work-log engine's done log at the main path, for one checkout of this
repository: saved with ``torch.save``, and two saved done logs compared bit
for bit.  Phase times come from ``chip_smoke.py`` (4b and 5), not from here.

The main path: 1M electrons, capacity 2M, grid 256^3, T=100, the bundled
sine table, scheduler ``dynamic``.  Each step runs the field phase, then
``ops.kernels.worklog.mobility_phase_worklog``, and the next step starts
from its output; the output of step ``--step`` is saved.  Only entry points
that every version of the port has are called, so ``--tree`` may name
another checkout (a ``git archive`` of an earlier commit): its package is
imported in place of this one.  Run it as a file, so that ``--tree``
decides which package loads:

    python particle_simulation_tpu_torch/probes/worklog_phase.py \\
        [--tree DIR] [--step 3] --save FILE
    python particle_simulation_tpu_torch/probes/worklog_phase.py \\
        --compare FILE FILE

A done log at the main path is 96 MB.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

FIELDS = ("pos", "vel", "acc", "status", "id_hi", "id_lo")
MAIN = dict(init_n=1_000_000, capacity=2_000_000, poisson_timestep=100,
            grid_size=(256, 256, 256), scheduler="dynamic")


def save(tree: str, step: int, path: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from particle_simulation_tpu_torch import SimConfig, cross_section
    from particle_simulation_tpu_torch.ops.kernels.worklog import (
        mobility_phase_worklog,
    )
    from particle_simulation_tpu_torch.ops.step import grid_phase
    from particle_simulation_tpu_torch.state import setup_particles

    if not torch.cuda.is_available():
        raise SystemExit("worklog_phase: the probe runs the card; no CUDA")
    dev = torch.device("cuda", 0)
    cfg = SimConfig(**MAIN)
    table = cross_section.load_table(cross_section.bundled_paths()[0], dev)
    st = setup_particles(cfg, device=dev)
    for s in range(step + 1):
        st, info = mobility_phase_worklog(grid_phase(st, cfg), s, table, cfg,
                                          cfg.poisson_timestep)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"n": st.n, "info": info,
                **{f: getattr(st, f).cpu() for f in FIELDS}}, path)
    print(f"{os.path.abspath(tree)}: step {step} n={st.n} {info}; done log "
          f"saved to {path}")


def compare(a_path: str, b_path: str) -> bool:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    same = a["n"] == b["n"] and a["info"] == b["info"]
    for f in FIELDS:
        x, y = a[f].contiguous(), b[f].contiguous()
        bits_x, bits_y = x.view(torch.int32), y.view(torch.int32)
        eq = x.shape == y.shape and torch.equal(bits_x, bits_y)
        same = same and eq
        digest = [hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]
                  for t in (bits_x, bits_y)]
        print(f"{f}: {'equal' if eq else 'DIFFERENT'} sha256 {digest[0]} "
              f"{digest[1]}")
    print(f"n {a['n']} {b['n']}; info equal: {a['info'] == b['info']}")
    print(f"done logs bit for bit equal: {same}")
    return same


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose package runs (default: this one)")
    ap.add_argument("--step", type=int, default=3,
                    help="the Poisson step whose done log is saved")
    ap.add_argument("--save", help="torch.save the done log here")
    ap.add_argument("--compare", nargs=2, metavar="FILE",
                    help="compare two saved done logs instead of running")
    args = ap.parse_args(argv)
    if args.compare:
        return 0 if compare(*args.compare) else 1
    if not args.save:
        ap.error("give --save FILE or --compare FILE FILE")
    save(args.tree, args.step, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
