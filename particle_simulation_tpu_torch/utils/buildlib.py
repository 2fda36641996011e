"""Build a native library of the port at first use: the CUDA kernels
(``ops/kernels/build.py``) and the IO library (``utils/fastio.py``).

A library is named by a hash of its sources and flags, so a checkout builds
each once.  Each build writes a file of its own and renames it into place
(``os.replace``), so processes that build the same library at once, such as
test workers or ranks, each load a whole file.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, Iterable, Tuple


def source_hash(flags: Iterable[str], paths: Iterable[str]) -> str:
    """16 hex digits of a hash of the flags and of each source's name and
    bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build_once(so: str, build: Callable[[str], str]) -> Tuple[float, str]:
    """Build ``so`` unless it exists: ``build(tmp)`` writes the library to
    ``tmp`` and returns what the build printed, or raises with it.  Returns
    (seconds, what the build printed; empty where ``so`` existed)."""
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            log = build(tmp)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return time.perf_counter() - t0, log
