"""Loader of the endpoint-extension kernel (``csrc/extend.cu``). The
wrapper and its plain version are ``engine/seed_mode.extend_runs`` and
``_extend_core``. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

from slamem_tpu_torch.kernels import build_nvcc

_SOURCE = Path(__file__).parent / "csrc" / "extend.cu"


class _Kernel(NamedTuple):
    fn: ctypes._CFuncPtr       # slamem_extend_runs
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the extension kernel."""
    path, log = build_nvcc(_SOURCE, "extend")
    fn = ctypes.CDLL(str(path)).slamem_extend_runs
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _Kernel(fn, path, log)
