"""The port's native IO library (``utils/fastio.py``, ``csrc/fastio.c``)
against the JAX package: tables parse to the same float64 values as JAX's
``load_table`` (``np.loadtxt``), as JAX's own C extension (compiled here
into a temporary directory) and as the plain twin, bit for bit; malformed
tables raise where ``np.loadtxt`` raises; PNG bytes equal JAX's pure-Python
encoder's under the same zlib, and the pixels decode equal; appended lines
equal byte for byte; the library builds atomically and a failed build
raises with the compiler's output.  Tolerance: exact."""

import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import zlib

import numpy as np
import pytest

import particle_simulation_tpu.utils as jutils
from particle_simulation_tpu import cross_section as jcs
from particle_simulation_tpu import observability as jobs
from particle_simulation_tpu_torch import cross_section, observability
from particle_simulation_tpu_torch.state import setup_particles
from particle_simulation_tpu_torch.utils import fastio

from test_torch_runtime import CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = cross_section.N_STEPS


def _odd_table(path):
    """A well-formed table in every form the parser takes: tabs, CRLF,
    scientific notation, signs, a comment, blank lines and extra rows."""
    rng = np.random.default_rng(7)
    values = rng.uniform(0.0, 100.0, (N + 5, 2))
    values[::7] *= 1e-9
    forms = ("{:.17g} {:.17g}\n", "{!r}\t{!r}\r\n", "  {:e}  \t {:E}\n",
             "+{:.9f} {:.3e}   \n")
    with open(path, "w", newline="") as f:
        f.write("# split remove\n\n")
        for i, (a, b) in enumerate(values.tolist()):
            f.write(forms[i % len(forms)].format(a, b))
            if i % 1000 == 3:
                f.write("\t \r\n")


def _table(name, d):
    """The path of a well-formed table by name."""
    sine, const = cross_section.bundled_paths()
    made = {
        "generate": lambda: jcs.generate_table(),
        "physical": lambda: jcs.physical_table(
            lambda e: 1e-20 / (1.0 + e / 1e12), lambda e: 3e-21 + 0.0 * e,
            gas_density=1e22, dt=1e-11),
        "argon_like": lambda: jcs.argon_like_table(gas_density=1e23,
                                                   dt=1e-12),
    }
    if name == "bundled_sine":
        return sine
    if name == "bundled_const":
        return const
    path = os.path.join(d, f"{name}.txt")
    if name == "odd":
        _odd_table(path)
    else:
        jcs.write_table(path, made[name]())
    return path


TABLES = ("bundled_sine", "bundled_const", "generate", "physical",
          "argon_like", "odd")


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.fixture
def jax_pure_python(monkeypatch):
    """The JAX package with its optional C extension unimportable, so its
    ``load_table`` reads by ``np.loadtxt`` and its ``write_png`` encodes in
    Python, whether or not the extension was built in place."""
    monkeypatch.setitem(sys.modules, "particle_simulation_tpu.utils.fastio",
                        None)
    monkeypatch.delattr(jutils, "fastio", raising=False)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's C extension (native/fastio.c), compiled into a
    temporary directory and imported from there."""
    include = sysconfig.get_paths()["include"]
    cc = shutil.which("cc") or shutil.which("gcc")
    if not os.path.exists(os.path.join(include, "Python.h")):
        pytest.skip(f"no Python.h under {include}")
    if cc is None:
        pytest.skip("no C compiler")
    d = tmp_path_factory.mktemp("jax_native")
    so = str(d / f"_fastio{sysconfig.get_config_var('EXT_SUFFIX')}")
    res = subprocess.run(
        [cc, "-O2", "-shared", "-fPIC", f"-I{include}", "-o", so,
         os.path.join(REPO, "native", "fastio.c"), "-lz"],
        capture_output=True, text=True)
    if res.returncode != 0 and "zlib.h" in res.stderr:
        pytest.skip("no zlib.h")
    assert res.returncode == 0, res.stderr
    spec = importlib.util.spec_from_file_location("_fastio", so)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_jax_load_table(name, tmp_path):
    path = _table(name, str(tmp_path))
    native = fastio.parse_float_pairs(path, N)
    plain = fastio.parse_float_pairs_plain(path, N)
    assert native.shape == (N, 2) and native.dtype == np.float64
    np.testing.assert_array_equal(_bits(native), _bits(plain))
    want = np.asarray(jcs.load_table(path))
    np.testing.assert_array_equal(_bits(native.astype(np.float32)),
                                  _bits(want))
    np.testing.assert_array_equal(
        _bits(cross_section.load_table(path, "cpu").numpy()), _bits(want))


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_jax_native_parser(name, tmp_path, jax_native):
    path = _table(name, str(tmp_path))
    theirs = np.frombuffer(jax_native.parse_float_pairs(path, N),
                           np.float64).reshape(N, 2)
    np.testing.assert_array_equal(_bits(fastio.parse_float_pairs(path, N)),
                                  _bits(theirs))


def _malformed(kind, path):
    rows = [f"{i}.5 {i}.25" for i in range(N)]
    if kind == "short":
        rows = rows[:2]
    elif kind == "three_columns":
        rows = [f"{r} 1.0" for r in rows]
    elif kind == "header_word":
        rows = ["split remove"] + rows
    elif kind == "one_column_row":
        rows[17] = "17.5"
    elif kind == "glued_numbers":
        rows[5] = "5.5-2.0 1.0"
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


MALFORMED = ("short", "three_columns", "header_word", "one_column_row",
             "glued_numbers")


@pytest.mark.parametrize("kind", MALFORMED)
def test_malformed_tables_raise_as_loadtxt_does(kind, tmp_path,
                                                jax_pure_python):
    path = str(tmp_path / "bad.txt")
    _malformed(kind, path)
    with pytest.raises(ValueError):
        jcs.load_table(path)
    with pytest.raises(ValueError):
        fastio.parse_float_pairs_plain(path, N)
    with pytest.raises(ValueError, match=r"expected \(10000, 2\)"):
        fastio.parse_float_pairs(path, N)
    with pytest.raises(ValueError, match=r"expected \(10000, 2\)"):
        cross_section.load_table(path, "cpu")


def test_jax_native_parser_mispairs_what_the_port_refuses(tmp_path,
                                                          jax_native):
    """The reference fault the port does not inherit: JAX's extension reads
    a three-column table as pairs, and "nan" inside a word as a number."""
    path = str(tmp_path / "bad.txt")
    with open(path, "w") as f:
        f.write("1 2 3\n4 5 6\n")
    pairs = np.frombuffer(jax_native.parse_float_pairs(path, 3), np.float64)
    np.testing.assert_array_equal(pairs, [1, 2, 3, 4, 5, 6])
    with pytest.raises(ValueError, match="line 1"):
        fastio.parse_float_pairs(path, 3)
    with open(path, "w") as f:
        f.write("time in nanoseconds 1\n2 3\n")
    pairs = np.frombuffer(jax_native.parse_float_pairs(path, 2), np.float64)
    assert np.isnan(pairs[0]) and list(pairs[1:]) == [1, 2, 3]
    with pytest.raises(ValueError, match="line 1"):
        fastio.parse_float_pairs(path, 2)


def test_missing_table_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        fastio.parse_float_pairs(str(tmp_path / "none.txt"), N)


def _scatter(resolution):
    """The log hook's image of a small seeded state."""
    st = setup_particles(CFG.replace(init_n=2000), device="cpu")
    return observability.render_particles(st.pos[:st.n].numpy(),
                                          CFG.sim_size, resolution)


@pytest.mark.parametrize("resolution", [512, 37])
def test_png_equals_jax_pure_python_encoder(resolution, tmp_path,
                                            jax_pure_python):
    img = _scatter(resolution)
    img[3, :, 1] = np.arange(resolution) % 256  # colours too
    ours, plain, theirs = (str(tmp_path / f"{k}.png")
                           for k in ("ours", "plain", "theirs"))
    calls = fastio.write_png.calls
    observability.write_png(ours, img)
    assert fastio.write_png.calls == calls + 1
    fastio.write_png_plain(plain, img)
    jobs.write_png(theirs, img)
    with open(plain, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    if fastio.load().zlib_version() == zlib.ZLIB_RUNTIME_VERSION:
        with open(ours, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read()
    for path in (ours, theirs):
        np.testing.assert_array_equal(observability.read_png(path), img)


def test_png_rejects_other_shapes(tmp_path):
    for shape in ((4, 5), (4, 5, 4), (0, 5, 3)):
        with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
            fastio.write_png(str(tmp_path / "x.png"), np.zeros(shape))


def test_append_lines_equals_plain_and_jax_native(tmp_path, jax_native):
    batches = (["func,init n,final n", "dynamic,1000,1234"],
               [], ["naïve,2,3", ""])
    paths = [str(tmp_path / f"{k}.csv") for k in ("ours", "plain", "jax")]
    for path in paths:
        with open(path, "w") as f:
            f.write("existing\n")
    calls = fastio.append_lines.calls
    for batch in batches:
        fastio.append_lines(paths[0], iter(batch))
        fastio.append_lines_plain(paths[1], iter(batch))
        jax_native.append_lines(paths[2], batch)
    assert fastio.append_lines.calls == calls + len(batches)
    got = []
    for path in paths:
        with open(path, "rb") as f:
            got.append(f.read())
    assert got[0] == got[1] == got[2]
    assert got[0].decode() == ("existing\nfunc,init n,final n\n"
                               "dynamic,1000,1234\nnaïve,2,3\n\n")
    with pytest.raises(TypeError):
        fastio.append_lines(paths[0], [1])


_RACE = """
import os, sys, time
from particle_simulation_tpu_torch.utils import fastio
fastio.BUILD_DIR = sys.argv[1]
print("ready", flush=True)
while not os.path.exists(sys.argv[2]):
    time.sleep(0.001)
lib = fastio.load()
rows = fastio.parse_float_pairs(sys.argv[3], 10000)
print(lib.path, rows.shape, flush=True)
"""


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    build_dir, go = str(tmp_path / "build"), str(tmp_path / "go")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACE, build_dir, go,
         cross_section.bundled_paths()[0]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for _ in range(3)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "ready"
        open(go, "w").close()
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip().endswith("(10000, 2)"), out
    assert len({out.split()[0] for out, _ in outs}) == 1
    assert os.listdir(build_dir) == [
        os.path.basename(outs[0][0].split()[0])]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "fastio.c"
    src.write_text("int pst_broken(void) { return undeclared_name; }\n")
    monkeypatch.setattr(fastio, "SOURCE", str(src))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="undeclared_name"):
        fastio.load.__wrapped__()
    assert os.listdir(tmp_path / "build") == []
    monkeypatch.setattr(fastio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        fastio.load.__wrapped__()
