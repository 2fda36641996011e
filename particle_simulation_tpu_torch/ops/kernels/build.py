"""Build and load the port's CUDA kernels.

``nvcc`` compiles each source of ``SOURCES`` for Hopper (``sm_90a``), all at
once in parallel processes, and links the objects into one shared library
with a plain C interface, loaded with ``ctypes``: seconds of build, against
minutes for an extension that includes PyTorch's headers.  The build runs
at first use into ``particle_simulation_tpu_torch/build/``, named by a hash
of the sources and flags, so a checkout builds once.

Flags that the parity with the JAX package depends on: ``-fmad=false`` (the
only fused multiply-adds are the explicit ``__fmaf_rn`` sites) and no
fast-math flag (``logf`` stays the full-accuracy one).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

from ...cross_section import N_STEPS
from ...utils.buildlib import build_once, source_hash
from . import push_mcc, worklog

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("worklog.cu", "staged.cu", "field.cu", "compact.cu",
           "sublane_gather.cu", "lookup_bench.cu", "setup.cu")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_D = ctypes.c_double

# the phase kernels' arguments from the table on: the physics
# (engine.phys_args) and the stream
_PHASE_TAIL = (
    _P,                     # table
    _F, _F, _F, _F, _F,     # dt, half_dt, size_x, size_y, size_z
    _F, _F,                 # log10_e, bucket_scale
    _U, _U, _I,             # seed, poisson_step, t_steps
    _I, _I, _I,             # depth, rounds, block2
    _I, _F, _F, _F,         # model, t (boris rotation)
    _F, _F, _F,             # s (boris rotation)
    _P,                     # stream
)

# argument types of each exported C function, in order
SIGNATURES = {
    "pst_worklog_phase": (
        _P, _P, _P,             # pos, vel, acc
        _P, _P, _P, _I,         # status, id_hi, id_lo, n0
        _P, _P, _P,             # out_pos, out_vel, out_acc
        _P, _P, _P, _LL,        # out_status, out_id_hi, out_id_lo, capacity
        _LL,                    # clear_to
        _P, _LL,                # logs, work_cap
        _P, _LL, _P,            # lookback, tiles_max, result
        *_PHASE_TAIL,
    ),
    "pst_staged_phase": (
        _P, _P, _P,             # pos, vel, acc
        _P, _P, _P, _LL,        # status, id_hi, id_lo, n0
        _P, _P, _P,             # out_pos, out_vel, out_acc
        _P, _P, _P, _LL,        # out_status, out_id_hi, out_id_lo, capacity
        _LL,                    # clear_to
        _P, _P, _P,             # stacks, stage, list
        _P, _LL, _P,            # lookback, tiles_max, result
        *_PHASE_TAIL,
    ),
    "pst_worklog_open_blocks": (
        _I, _I, _P,             # block2, general, int* blocks
    ),
    "pst_staged_open_blocks": (
        _I, _I, _I, _P,         # block2, general, depth, int* blocks
    ),
    "pst_banded_gather": (
        _P, _P, _P, _P, _LL,    # table, rows, lanes, out, n
        _P,                     # stream
    ),
    "pst_packed_field_gather": (
        _P, _P, _P, _F,         # packed, flat, weight, e_const
        _P, _LL,                # out, n
        _P,                     # stream
    ),
    "pst_subgrid_bbox": (
        _P, _P, _LL, _F,        # pos, status, m, inv
        _I, _I, _I, _P,         # gx, gy, gz, words
        _P,                     # stream
    ),
    "pst_subgrid_deposit": (
        _P, _P, _LL, _F,        # pos, status, m, inv
        _I, _I, _I,             # gx, gy, gz
        _I, _I, _I, _I,         # ox, oy, oz, s
        _P, _P,                 # counts, stream
    ),
    "pst_subgrid_field_store": (
        _P, _P, _LL, _LL, _F,   # pos, status, m, capacity, inv
        _I, _I, _I,             # gx, gy, gz
        _I, _I, _I, _I,         # ox, oy, oz, s
        _P, _F, _P,             # counts, e_const, acc
        _P,                     # stream
    ),
    "pst_row_compact": (
        _P, _P, _P, _P, _LL,    # x, out, ptr, state, n_rows
        _P,                     # stream
    ),
    "pst_sublane_gather": (
        _P, _P, _P, _I, _LL,    # x, idx, out, s, n
        _I, _P,                 # both, stream
    ),
    "pst_lookup_bench": (
        _P, _P, _P, _P, _LL,    # x, split, remove, out, n
        _I, _I, _I,             # table_elems, t_steps, variant
        _P,                     # stream
    ),
    "pst_lookup_bench_banked_blocks": (
        _P,                     # int* blocks per SM
    ),
    "pst_setup_seed": (
        _P, _P, _P,             # pos, vel, acc
        _P, _P, _P,             # status, id_hi, id_lo
        _LL, _LL, _LL, _U,      # capacity, init_n, slot_offset, seed
        _F, _F, _F,             # lo (shift) of each axis
        _F, _F, _F,             # scale of each axis
        _D, _I, _I,             # vth, thermal_start, f64
        _P,                     # stream
    ),
}


# the open instantiations take the compiled ones' arguments, then their
# children scratch and its blocks, before the stream
SIGNATURES.update({
    f"pst_{e}_phase_open": (*SIGNATURES[f"pst_{e}_phase"][:-1], _P, _LL, _P)
    for e in ("worklog", "staged")
})


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def nvcc_flags() -> list:
    """Compile flags of every source (the link adds ``-shared``)."""
    return [
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
        "-fmad=false", "-Xptxas", "-v",
        f"-DPST_N_STEPS={N_STEPS}", *worklog.kernel_defines(),
        *push_mcc.kernel_defines(),
    ]


def _sources() -> list:
    """The CUDA sources and headers, whose bytes name the library."""
    return [os.path.join(CSRC, name) for name in sorted(os.listdir(CSRC))
            if name.endswith((".cu", ".cuh"))]


class KernelLibrary:
    """The loaded shared library, with what its build printed."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def load() -> KernelLibrary:
    """Build (if this source hash was not built yet) and load the kernels."""
    flags = nvcc_flags()
    so = os.path.join(BUILD_DIR,
                      f"libpst_kernels_{source_hash(flags, _sources())}.so")

    def compile_and_link(tmp: str) -> str:
        nvcc = nvcc_path()
        objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *flags, "-c", "-o", obj, os.path.join(CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        log, failed = "", []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            log += f"{src}:\n{out}"
            if proc.returncode != 0:
                failed.append(src)
        if not failed:
            res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
            log += res.stdout + res.stderr
            if res.returncode != 0:
                failed.append("link")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        return log

    seconds, log = build_once(so, compile_and_link)
    return KernelLibrary(so, seconds, log)
