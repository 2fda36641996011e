"""The port's analysis scripts (``particle_simulation_tpu_torch/analyse``):
tests/test_analyse.py's four cases on the port's modules, the one-plot
scripts, ``plot_validation`` and ``plot_cc --run --device cpu`` at a tiny
configuration, and ``analyse_random``'s histogram against the JAX
script's.  Every plot is written under ``tmp_path`` and decoded by
``observability.read_png``; nothing is written into the repository."""

import glob
import os

import numpy as np
import pytest

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.analyse import (
    analyse_random, plot_cc, plot_init_n, plot_mobility,
    plot_particles_added, plot_poisson_steps, plot_tile, plot_validation,
    to_gif,
)
from particle_simulation_tpu_torch.analyse.common import lineplot, load_runs
from particle_simulation_tpu_torch.observability import (
    CSV_HEADER, read_png, write_png,
)


def _png(path) -> np.ndarray:
    img = read_png(str(path))
    assert img.ndim == 3 and img.shape[2] == 3 and img.shape[0] > 100
    assert img.min() < img.max()  # something was drawn
    return img


def _sweep_csv(path, scheds=("Naive", "Dynamic"), steps=(10, 20, 40)):
    rows = [CSV_HEADER]
    for sched in scheds:
        for t in steps:
            for rep in (1.0, 1.1):  # repetitions: the min..max band
                rows.append(f"{sched},1000,2,{t},256,100,0,{1234 + t},"
                            f"{t * 1.5 * rep}")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_load_and_plot(tmp_path):
    csv = _sweep_csv(tmp_path / "sweep.csv")
    df = load_runs(csv)
    assert len(df) == 12
    assert set(df["func"]) == {"Naive", "Dynamic"}
    out = tmp_path / "plot.png"
    lineplot(df, "mobility steps", "time", "func", str(out), logy=True)
    _png(out)


def test_cc_plot(tmp_path):
    csv = tmp_path / "pic_cc.csv"
    rows = [plot_cc.CC_HEADER]
    for sched in ("Naive", "Dynamic"):
        for cc in (0.1, 1.0, 10.0):
            rows.append(f"{sched},1000,2,20,256,100,{cc},1234,{cc * 7.5}")
    csv.write_text("\n".join(rows) + "\n")
    out = tmp_path / "cc.png"
    plot_cc.plot(str(csv), str(out))
    _png(out)


def test_plot_all(tmp_path):
    from particle_simulation_tpu_torch.analyse.plot_all import load_all, plot

    data = tmp_path / "out" / "data"
    data.mkdir(parents=True)
    for name in ("a.csv", "b.csv"):
        rows = [CSV_HEADER]
        for t in (10, 20):
            rows.append(f"Dynamic,1000,2,{t},256,100,0,55,{t * 2.5}")
        (data / name).write_text("\n".join(rows) + "\n")
    (data / "other.csv").write_text("a,b\n1,2\n")  # not a timing CSV
    df = load_all(data_dir=str(data))
    assert set(df["source"]) == {"a.csv", "b.csv"}
    out = tmp_path / "overview.png"
    plot(df, str(out))
    _png(out)
    with pytest.raises(SystemExit, match="no timing CSVs"):
        load_all(prefix="zzz", data_dir=str(data))


def test_gif_assembly(tmp_path):
    from PIL import Image

    src = tmp_path / "viz"
    src.mkdir()
    r = np.random.default_rng(0)
    for i in range(3):
        write_png(str(src / f"test_{i:04d}.png"),
                  r.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    gif = tmp_path / "gif" / "result.gif"
    assert to_gif.main(str(src), str(gif)) == 3
    assert Image.open(str(gif)).n_frames == 3
    with pytest.raises(SystemExit, match="no frames"):
        to_gif.main(str(tmp_path / "empty"), str(gif))


@pytest.mark.parametrize("module", [plot_init_n, plot_mobility,
                                    plot_particles_added, plot_poisson_steps])
def test_one_plot_scripts(tmp_path, module):
    csv = _sweep_csv(tmp_path / "sweep.csv")
    out = tmp_path / "plot.png"
    assert module.main([csv, str(out)]) == str(out)
    _png(out)


def test_plot_tile(tmp_path):
    csv = tmp_path / "tile.csv"
    rows = [CSV_HEADER]
    for t in (10, 100):
        for tile in (64, 128, 256):
            rows.append(f"Dynamic,1000,2,{t},{tile},0,0,1000,{tile * 0.1}")
    csv.write_text("\n".join(rows) + "\n")
    out = tmp_path / "tile.png"
    plot_tile.main([str(csv), str(out)])
    _png(out)


def test_default_outputs_are_under_out_torch():
    """No default output path points at the JAX package's tracked plots
    or data."""
    outs = [plot_cc.CC_CSV, plot_cc.CC_PNG,
            plot_validation.main.__defaults__[0],
            analyse_random.main.__defaults__[0],
            to_gif.main.__defaults__[1]]
    for path in outs:
        assert path.startswith(os.path.join("out", "torch") + os.sep), path


def test_plot_validation_tiny(tmp_path):
    out = tmp_path / "validation.png"
    measured = plot_validation.main(str(out), device="cpu", n0=2000,
                                    t_steps=4, k_steps=2, capacity=1 << 14)
    _png(out)
    for (s, r), ns in measured.items():
        assert len(ns) == 3
        for k in (1, 2):
            mean, var = plot_validation.branching_moments(2000, s, r, 4 * k)
            assert abs(ns[k] - mean) <= 4 * var ** 0.5, (s, r, k)


def test_plot_cc_run_on_the_cpu(tmp_path):
    csv = tmp_path / "cc.csv"
    out = tmp_path / "cc.png"
    base = SimConfig(init_n=200, capacity=8192, poisson_steps=2,
                     poisson_timestep=4, grid_size=(32, 32, 32))
    got = plot_cc.main(["--run", "--device", "cpu", str(csv), str(out)],
                       base=base)
    assert got == str(out)
    _png(out)
    lines = csv.read_text().splitlines()
    assert lines[0] == plot_cc.CC_HEADER
    rows = [line.split(",") for line in lines[1:]]
    assert len(rows) == len(plot_cc.CHANCES) * len(plot_cc.SCHEDULERS)
    # the four schedulers agree on the final population at every chance
    for i in range(0, len(rows), len(plot_cc.SCHEDULERS)):
        assert len({row[7] for row in rows[i:i + 4]}) == 1
    assert {row[0] for row in rows} == {
        "Dynamic", "CPU Sync", "Naive", "Dynamic Old"}


def test_analyse_random_equals_the_jax_script(tmp_path):
    """The JAX script's lines (analyse/analyse_random.py:8-10) against the
    port's ``histogram``: the same counts."""
    from particle_simulation_tpu import rng as jrng

    ids_hi, ids_lo = jrng.initial_ids(39587, np.arange(100_000))
    u = np.asarray(jrng.step_uniform(39587, ids_hi, ids_lo, 0, 1, 0.0, 100.0))
    want, want_edges = np.histogram(u, bins=20, range=(0, 100))
    got, edges = analyse_random.histogram(device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(edges, want_edges)
    out = tmp_path / "hist.png"
    chi2 = analyse_random.main(str(out), device="cpu")
    _png(out)
    assert chi2 == pytest.approx(
        ((want - want.mean()) ** 2 / want.mean()).sum())


def test_scripts_write_nothing_into_the_repository(tmp_path, monkeypatch):
    """Run from a scratch directory, the scripts' defaults land under
    ``out/torch/`` there."""
    monkeypatch.chdir(tmp_path)
    csv = _sweep_csv(tmp_path / "sweep.csv")
    plot_mobility.main([csv])
    analyse_random.main(device="cpu")
    made = sorted(glob.glob("out/**/*.png", recursive=True))
    assert made == ["out/torch/plots/random_hist.png",
                    "out/torch/plots/time_vs_mobility.png"]
