"""The port's native IO library (counterpart of
``particle_simulation_tpu/utils/fastio.py``): the cross-section table
parser, the PNG encoder and the CSV appender, in C (``csrc/fastio.c``).

The host C compiler (``cc``, else ``gcc``) builds the library at first use
into ``particle_simulation_tpu_torch/build/``, named by a hash of its source
and flags (``utils/buildlib.py``), and ``ctypes`` loads it.  A missing
compiler, or a build or load that fails, raises with the compiler's output:
no caller falls back to Python.

Beside each function stands its plain twin in Python and numpy, which the
tests and ``chip_smoke.py`` hold it against.  Each function counts its
calls of the library in ``<function>.calls``.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import os
import shutil
import struct
import subprocess
import zlib
from typing import Iterable

import numpy as np

from .buildlib import build_once, source_hash

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fastio.c")
BUILD_DIR = os.path.join(_PKG, "build")
CFLAGS = ("-O2", "-std=c99", "-fPIC", "-shared")
LIBS = ("-lz",)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_LEVEL = 6  # zlib's level for the IDAT, as the JAX package writes it

# the library's error codes (csrc/fastio.c)
_IO_ERROR, _BAD_LINE, _NO_MEMORY, _ZLIB_ERROR = -1, -2, -3, -4

_P = ctypes.c_void_p
_S = ctypes.c_char_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# (restype, argtypes) of each exported C function
SIGNATURES = {
    "pst_parse_float_pairs": (_LL, (_S, _LL, _P, _P)),
    "pst_write_png": (_I, (_S, _P, _I, _I, _I)),
    "pst_append_lines": (_I, (_S, _S, _LL)),
    "pst_zlib_version": (_S, ()),
}


def compiler() -> str:
    """The host C compiler: ``cc``, else ``gcc``."""
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no C compiler (cc or gcc) on the PATH: the port's IO library "
        f"({SOURCE}) is built at first use")


class NativeIO:
    """The loaded library, with the compiler and what its build printed."""

    def __init__(self, path: str, cc: str, build_seconds: float,
                 build_log: str):
        self.path = path
        self.compiler = cc
        self.build_seconds = build_seconds
        self.build_log = build_log
        try:
            self.lib = ctypes.CDLL(path, use_errno=True)
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}\n{build_log}") from e
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.restype = restype
            fn.argtypes = list(argtypes)

    def zlib_version(self) -> str:
        return self.lib.pst_zlib_version().decode()


@functools.lru_cache(maxsize=None)
def load() -> NativeIO:
    """Build (if this source hash was not built yet) and load the library."""
    cc = compiler()
    flags = (*CFLAGS, *LIBS)
    so = os.path.join(BUILD_DIR,
                      f"libpst_fastio_{source_hash(flags, [SOURCE])}.so")

    def compile_(tmp: str) -> str:
        res = subprocess.run([cc, *CFLAGS, "-o", tmp, SOURCE, *LIBS],
                             capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"{cc} failed on {SOURCE}:\n{log}")
        return log

    seconds, log = build_once(so, compile_)
    return NativeIO(so, cc, seconds, log)


def _check(code: int, path: str) -> None:
    """Raise for a negative code of the library."""
    if code == _IO_ERROR:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err), path)
    if code == _NO_MEMORY:
        raise MemoryError(f"the IO library ran out of memory on {path!r}")
    if code == _ZLIB_ERROR:
        raise RuntimeError(f"zlib failed to compress the image for {path!r}")
    if code < 0:
        raise RuntimeError(f"the IO library returned {code} on {path!r}")


def _shape_error(path: str, shape, n: int) -> ValueError:
    return ValueError(f"table {path!r} has shape {shape}, expected ({n}, 2)")


def parse_float_pairs(path: str, n: int) -> np.ndarray:
    """The first ``n`` rows of a table of float pairs -> (n, 2) float64.

    Each line holds two numbers apart by blanks (spaces, tabs, a CR), read
    by ``strtod``; text from ``#`` on is a comment and lines with nothing
    else are skipped.  A line with another count of numbers, or a word,
    raises ValueError, as do fewer than ``n`` rows.  On every such table
    the values equal ``np.loadtxt``'s (``parse_float_pairs_plain``)."""
    n = operator.index(n)
    if n < 0:
        raise ValueError(f"n must be at least 0, not {n}")
    out = np.empty((n, 2), np.float64)
    bad_line = ctypes.c_longlong(0)
    lib = load().lib
    parse_float_pairs.calls += 1
    rows = lib.pst_parse_float_pairs(os.fsencode(path), n, out.ctypes.data,
                                     ctypes.addressof(bad_line))
    if rows == _BAD_LINE:
        raise ValueError(f"table {path!r}: line {bad_line.value} does not "
                         f"hold two numbers, expected ({n}, 2)")
    _check(rows, path)
    if rows != n:
        raise _shape_error(path, (rows, 2), n)
    return out


def parse_float_pairs_plain(path: str, n: int) -> np.ndarray:
    """``parse_float_pairs`` by ``np.loadtxt``."""
    data = np.loadtxt(path, dtype=np.float64, max_rows=n, ndmin=2)
    if data.shape != (n, 2):
        raise _shape_error(path, data.shape, n)
    return data


def _rgb(rgb) -> np.ndarray:
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape:
        raise ValueError(f"an image is (H, W, 3) with H, W > 0, not "
                         f"{rgb.shape}")
    return rgb


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) image, uint8 or converted to it, as a PNG file:
    8-bit RGB, filter 0 on every row, one IDAT at zlib level 6.  Its bytes
    equal ``write_png_plain``'s where the library's zlib
    (``load().zlib_version()``) is Python's (``zlib.ZLIB_RUNTIME_VERSION``)."""
    rgb = _rgb(rgb)
    h, w, _ = rgb.shape
    lib = load().lib
    write_png.calls += 1
    _check(lib.pst_write_png(os.fsencode(path), rgb.ctypes.data, w, h,
                             PNG_LEVEL), path)


def write_png_plain(path: str, rgb: np.ndarray) -> None:
    """``write_png`` in Python."""
    rgb = _rgb(rgb)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        PNG_SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, PNG_LEVEL))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def _blob(lines: Iterable[str]) -> bytes:
    return "".join(line + "\n" for line in lines).encode()


def append_lines(path: str, lines: Iterable[str]) -> None:
    """Append each string and a newline to the file, UTF-8 encoded."""
    blob = _blob(lines)
    lib = load().lib
    append_lines.calls += 1
    _check(lib.pst_append_lines(os.fsencode(path), blob, len(blob)), path)


def append_lines_plain(path: str, lines: Iterable[str]) -> None:
    """``append_lines`` in Python."""
    with open(path, "ab") as f:
        f.write(_blob(lines))


parse_float_pairs.calls = 0
write_png.calls = 0
append_lines.calls = 0
