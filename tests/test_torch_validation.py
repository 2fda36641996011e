"""Statistical validation of the port's plain path on the CPU, against
expectations computed outside the engines (the port of
tests/test_validation.py, which holds the JAX package to the same checks).

Where the port's parity with the JAX package is statistical (the three
``log``s of the lookup, the ``cos``/``sin`` of the isotropic model), these
checks cover what the exact tests cannot:

* a constant table makes every mobility step a Galton-Watson branching
  step per particle (split -> 2, remove -> 0, else 1; children join the
  next step): the population after each Poisson step must match the
  analytic mean within 4 sigma.  The branching law does not depend on the
  motion, so it holds under the boris push with a magnetic field, the
  isotropic model and the periodic box (where no lane leaves) as well;
* against the bundled sine table, the realised split and remove outcomes
  of one step must be binomially consistent with the table's chance at
  each particle's collision energy (a chi-square over energy groups).

Both runs are seeded and deterministic, so the bounds are stable.
"""

import math

import numpy as np
import pytest
import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import (
    N_STEPS, bundled_paths, load_table, write_table,
)
from particle_simulation_tpu_torch.ops.step import grid_phase
from particle_simulation_tpu_torch.runtime import run_pic
from particle_simulation_tpu_torch.state import setup_particles

MODELS = {
    "reference": {},
    "magnetized": dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                       collision_model="isotropic", boundary="periodic",
                       init_vth=2.0e6),
}


def branching_moments(n0, split_pct, remove_pct, n_steps):
    """Analytic (mean, variance) of the population after ``n_steps``
    mobility steps of the constant-table branching process: offspring 2
    with p_s, 0 with p_r, 1 otherwise; m = 1 + p_s - p_r and
    sigma^2 = 4 p_s + (1 - p_s - p_r) - m^2."""
    p_s, p_r = split_pct / 100.0, remove_pct / 100.0
    m = 1.0 + p_s - p_r
    var1 = 4.0 * p_s + (1.0 - p_s - p_r) - m * m
    mean = n0 * m**n_steps
    if abs(m - 1.0) < 1e-12:
        var = var1 * n_steps * n0
    else:
        var = var1 * m ** (n_steps - 1) * (m**n_steps - 1.0) / (m - 1.0) * n0
    return mean, var


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("split_pct,remove_pct", [(50.0, 50.0), (2.0, 1.0)])
def test_analytic_growth_const_table(tmp_path, model, split_pct, remove_pct):
    n0, t_steps, k_steps = 20_000, 10, 3
    path = str(tmp_path / "const.txt")
    write_table(path, np.full((N_STEPS, 2), 0.0, np.float32)
                + np.asarray([split_pct, remove_pct], np.float32))
    cfg = SimConfig(init_n=n0, capacity=1 << 17, poisson_steps=k_steps,
                    poisson_timestep=t_steps, grid_size=(32, 32, 32),
                    scheduler="naive", cross_section_path=path,
                    **MODELS[model])
    run = run_pic(cfg, device="cpu", print_header=False)
    assert not any(s.overflow for s in run.steps)
    assert n0 + run.total_added - run.total_removed == run.final_n
    for s in run.steps:
        mean, var = branching_moments(
            n0, split_pct, remove_pct, (s.step + 1) * t_steps)
        bound = 4.0 * math.sqrt(var)
        assert abs(s.n - mean) < bound, (
            f"step {s.step}: n={s.n} vs analytic {mean:.0f} +- {bound:.0f}")
    if model == "magnetized":
        pos = run.state.pos[: run.final_n].numpy()
        assert (pos >= 0).all() and (pos < cfg.sim_size[0]).all()


def _ids(state, n):
    hi = state.id_hi[:n].numpy().view(np.uint32).astype(np.uint64)
    lo = state.id_lo[:n].numpy().view(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def test_collision_rates_chi_square_sine():
    """One mobility step against the sine table: particles grouped by
    their collision energy, the realised split and remove counts of each
    group against the table's chances (Poisson-binomial mean and
    variance).  A removed parent's id is gone; a split parent survives
    with its velocity exactly reversed (the reverse model).  The predicted
    chance is the table's at E = |v - a dt|^2 from the port's own frozen
    acceleration, in numpy; lanes within a sliver of a bucket edge are
    left out."""
    cfg = SimConfig(init_n=120_000, capacity=1 << 17, poisson_steps=1,
                    poisson_timestep=1, grid_size=(32, 32, 32),
                    scheduler="naive", cross_section_path=bundled_paths()[0],
                    init_vth=1.0e3)
    table = load_table(cfg.cross_section_path, "cpu").numpy().astype(
        np.float64)
    state0 = setup_particles(cfg, device="cpu")
    n0 = cfg.init_n
    acc = grid_phase(state0, cfg).acc[:n0].numpy().astype(np.float64)
    v0 = state0.vel[:n0].numpy().astype(np.float64)
    ids0 = _ids(state0, n0)

    run = run_pic(cfg, device="cpu", print_header=False)
    fin_ids = _ids(run.state, run.final_n)
    fin_vel = run.state.vel[: run.final_n].numpy().astype(np.float64)
    id_to_row = {int(i): r for r, i in enumerate(fin_ids)}

    v_post = v0 - acc * cfg.mobility_dt
    e_post = np.sum(v_post * v_post, axis=1)
    frac = (np.log10(np.maximum(e_post, 1e-300)) + 6.0) * (N_STEPS / 22.0)
    idx = np.clip(np.trunc(frac), 0, N_STEPS - 1).astype(np.int64)
    safe = np.abs(frac - np.round(frac)) > 1e-3
    p_split = table[idx, 0] / 100.0
    p_remove = table[idx, 1] / 100.0

    removed = np.array([int(i) not in id_to_row for i in ids0])
    split = np.zeros(n0, bool)
    for k, i in enumerate(ids0):
        r = id_to_row.get(int(i))
        if r is not None:
            split[k] = bool(np.all(np.abs(fin_vel[r] + v_post[k])
                                   <= 1e-6 * np.abs(v_post[k]) + 1e-30))

    n_groups = 16
    order = np.argsort(idx)
    chi2, dof = 0.0, 0
    for g in range(n_groups):
        sel = order[(len(order) * g) // n_groups:
                    (len(order) * (g + 1)) // n_groups]
        sel = sel[safe[sel]]
        for p, obs in ((p_split[sel], split[sel].sum()),
                       (p_remove[sel], removed[sel].sum())):
            exp, var = p.sum(), (p * (1 - p)).sum()
            if var < 25:  # a group the normal approximation holds for
                continue
            chi2 += (obs - exp) ** 2 / var
            dof += 1
    assert dof >= 20, f"too few testable groups ({dof})"
    assert chi2 < dof + 4.5 * math.sqrt(2 * dof), (chi2, dof)
    assert chi2 > max(dof - 4.5 * math.sqrt(2 * dof), 0.5), (chi2, dof)
    assert torch.isfinite(run.state.vel[: run.final_n]).all()
