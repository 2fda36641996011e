"""How far the canonical sweep's final n moves under changes that the
physics is indifferent to, on the card.

Each row is the ``full`` profile's ``dynamic`` configuration at one T
(benchmarks.sweep_configs: 1M electrons, capacity 5e7, grid 512^3, 10
Poisson steps, rng_mode perstep), run through ``runtime.run_pic``:

* from the seed state (the sweep's row);
* ``--perturb`` times from the seed state with one electron's x moved up
  by one float32 ulp (electrons spread evenly over the population):
  whether one rounding difference spreads through the field, which
  couples the lineages;
* ``--seeds`` times from another seed: independent realizations;
* at the T of ``--variants-t``, from the seed state through the plain
  ``naive`` cadence on the card, as it is (torch's ``log``, which equals
  the kernels' ``logf``) and with one float32 rounding done otherwise:
  ``log`` in float64 rounded to float32 (a second implementation of
  ``log``, apart in the last bit on some energies), and the collision
  energy without its fused multiply-adds (apart in the last bit on many
  lanes every step, as a compiler that contracts otherwise would make
  it): what a rounding difference on the lookup's path makes of the row.

It prints each final n and the spread of each kind relative to the seed
state's run (root mean square and largest of |n - n_seed| / n_seed): the
scales against which ``chip_smoke.py`` 8c's difference from the TPU's
final n is read (PERF.md).

    python -m particle_simulation_tpu_torch.probes.sweep_sensitivity \\
        [--t 100 200 1000] [--perturb 3] [--seeds 3] [--variants-t 200]
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List

import torch

from .. import cross_section
from ..benchmarks import sweep_configs
from ..ops import physics
from ..cross_section import load_table
from ..fma import fma_f32
from ..runtime import run_pic
from ..state import setup_particles


def perturbed_state(cfg, k: int, of: int, device):
    """The seed state with electron ``(2k+1) n / (2 of)``'s x moved up by
    one float32 ulp."""
    st = setup_particles(cfg, device=device)
    i = (2 * k + 1) * cfg.init_n // (2 * of)
    st.pos[i, 0] = torch.nextafter(st.pos[i, 0],
                                   torch.tensor(math.inf, device=device))
    return st


def spread(ns: List[int], ref: int) -> Dict[str, float]:
    rel = [abs(n - ref) / ref for n in ns]
    return {"rms": math.sqrt(sum(r * r for r in rel) / len(rel)),
            "max": max(rel)} if rel else {"rms": 0.0, "max": 0.0}


def sensitivity(t: int, perturb: int, seeds: int, device) -> dict:
    """Final n at T=``t``: the seed state's run, the perturbed runs, the
    other seeds' runs, and the spread of each kind."""
    (cfg,) = [c for c in sweep_configs("full")
              if c.scheduler == "dynamic" and c.poisson_timestep == t]
    table = load_table(cfg.cross_section_path, device)

    def final_n(c, state=None):
        return run_pic(c, table, print_header=False, initial_state=state,
                       device=device).final_n

    base = final_n(cfg)
    moved = [final_n(cfg, perturbed_state(cfg, k, perturb, device))
             for k in range(perturb)]
    other = [final_n(cfg.replace(seed=cfg.seed + 1 + k))
             for k in range(seeds)]
    return {"t": t, "n": base, "perturbed": moved, "seeds": other,
            "perturbed_spread": spread(moved, base),
            "seed_spread": spread(other, base)}


def _energy_to_index_f64_log(energy: torch.Tensor) -> torch.Tensor:
    """``cross_section.energy_to_index`` with ``log`` in float64, rounded
    to float32."""
    log = torch.log(energy.double()).float()
    x = fma_f32(log, float(cross_section.LOG10_E), 6.0)
    idx = torch.trunc(x * torch.tensor(cross_section.BUCKET_SCALE,
                                       device=energy.device))
    idx = torch.where(torch.isnan(idx), torch.zeros_like(idx), idx)
    return torch.clamp(idx, 0, cross_section.N_STEPS - 1).to(torch.int32)


def _energy_unfused(p) -> torch.Tensor:
    """``physics.collision_energy`` rounded after every operation."""
    return (p.vx * p.vx + p.vy * p.vy) + p.vz * p.vz


VARIANTS = {
    "float64 log": (cross_section, "energy_to_index",
                    _energy_to_index_f64_log),
    "energy without fma": (physics, "collision_energy", _energy_unfused),
}


def arithmetic_variants(t: int, device) -> dict:
    """The row at T=``t`` through the plain naive cadence on ``device``,
    as it is and with each of ``VARIANTS``: name -> run."""
    (cfg,) = [c.replace(scheduler="naive") for c in sweep_configs("full")
              if c.scheduler == "dynamic" and c.poisson_timestep == t]
    table = load_table(cfg.cross_section_path, device)
    runs = {"as is": run_pic(cfg, table, print_header=False, device=device)}
    for name, (module, attr, fn) in VARIANTS.items():
        orig = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            runs[name] = run_pic(cfg, table, print_header=False,
                                 device=device)
        finally:
            setattr(module, attr, orig)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, nargs="+", default=[100, 200, 1000],
                    help="mobility steps per Poisson step, each a row")
    ap.add_argument("--perturb", type=int, default=3,
                    help="runs with one electron moved by one ulp")
    ap.add_argument("--seeds", type=int, default=3,
                    help="runs from other seeds")
    ap.add_argument("--variants-t", type=int, nargs="*", default=[],
                    help="T values whose row also runs with each variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_sensitivity: the probe runs the card; no CUDA")
    dev = torch.device("cuda", 0)
    for t in args.t:
        r = sensitivity(t, args.perturb, args.seeds, dev)
        p, s = r["perturbed_spread"], r["seed_spread"]
        print(f"T={t:4d} n={r['n']} perturbed {r['perturbed']} (rms "
              f"{100 * p['rms']:.4f}%, max {100 * p['max']:.4f}%) seeds "
              f"{r['seeds']} (rms {100 * s['rms']:.4f}%, max "
              f"{100 * s['max']:.4f}%)", flush=True)
    for t in args.variants_t:
        runs = arithmetic_variants(t, dev)
        base = runs["as is"].final_n
        for name, run in runs.items():
            d = run.final_n - base
            print(f"T={t:4d} naive, {name}: n={run.final_n} ({d:+d}, "
                  f"{100 * d / base:+.4f}%); per step "
                  f"{[m.n for m in run.steps]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
