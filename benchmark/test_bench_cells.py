"""The harness finds every configuration, traffic mix and metric by name,
and files added beside them add a cell without an edit."""

import json
import os
import shutil

import pytest

import harness

BENCH = harness.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = harness.find_cell(BENCH, name)
    keys = harness.run_keys(cell)
    assert {"init_n", "capacity", "poisson_timestep", "scheduler"} <= set(keys)
    assert os.path.exists(os.path.join(harness.BENCH_DIR,
                                       cell.config["table"]))
    assert os.path.exists(os.path.join(harness.BENCH_DIR,
                                       cell.config["reference"] + ".py"))
    assert [m["name"] for m in cell.end_to_end] == [
        "pushes_per_s", "episode_ms_p90", "setup_s"]
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))


def test_configs_are_the_upstream_row():
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert (cfg["init_n"], cfg["capacity"], cfg["poisson_steps"],
                cfg["grid_size"]) == (1_000_000, 50_000_000, 10,
                                      [512, 512, 512])
        assert c["reduced"] == []


def test_added_files_add_a_cell(tmp_path):
    """A new configuration, traffic mix and metric, each a file of its own
    and an entry in BENCHMARK.json, with no file of the harness edited."""
    root = tmp_path
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(root / "benchmark" / "configs" / "sine512.json"))
    cfg["init_n"] = 2_000_000
    (root / "benchmark" / "configs" / "sine512x2.json").write_text(
        json.dumps(dict(cfg, reference="pic_reference")))
    (root / "benchmark" / "traffic" / "t1000.dynamic.json").write_text(
        json.dumps({"poisson_timestep": 1000, "scheduler": "dynamic"}))
    (root / "benchmark" / "metrics" / "episodes.py").write_text(
        "def read(r):\n    return len(r.episode_s) or None\n")
    bench["configs"].append({"name": "sine512x2", "source": "x",
                             "file": "benchmark/configs/sine512x2.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "sine512x2.t1000.dynamic",
                               "config": "sine512x2",
                               "traffic": "t1000.dynamic", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({
        "name": "episodes", "unit": "1", "better": "higher", "bound": 0.01,
        "source": "host_clock", "workloads": ["sine512x2.t1000.dynamic"]})
    cell = harness.find_cell(bench, "sine512x2.t1000.dynamic", root=str(root))
    assert cell.config["init_n"] == 2_000_000
    assert harness.run_keys(cell)["poisson_timestep"] == 1000
    assert [m["name"] for m in cell.end_to_end][-1] == "episodes"
    read = harness.reader("episodes", bench_dir=str(root / "benchmark"))
    assert read(type("R", (), {"episode_s": [0.1, 0.2]})()) == 2
    # the new metric is the new cell's alone
    old = harness.find_cell(bench, "sine512.t100.dynamic", root=str(root))
    assert "episodes" not in [m["name"] for m in old.end_to_end]


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.find_cell(BENCH, "nope.t1.dynamic")
