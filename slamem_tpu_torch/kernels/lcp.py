"""Loader of the LCP array kernel (``csrc/lcp.cu``: one thread a row for
the first 32 characters of each adjacent pair, then one warp a pair for
the pairs equal on all of them). The wrapper and its plain version are
``index/lcp.lcp_adjacent`` and ``lcp_adjacent_plain``. Nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

from slamem_tpu_torch.kernels import build_nvcc

_SOURCE = Path(__file__).parent / "csrc" / "lcp.cu"


class _Kernel(NamedTuple):
    first: ctypes._CFuncPtr    # slamem_lcp_first
    long: ctypes._CFuncPtr     # slamem_lcp_long
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the LCP kernel."""
    path, log = build_nvcc(_SOURCE, "lcp")
    lib = ctypes.CDLL(str(path))
    first, long = lib.slamem_lcp_first, lib.slamem_lcp_long
    first.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p]
    first.restype = ctypes.c_int
    long.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_void_p]
    long.restype = ctypes.c_int
    return _Kernel(first, long, path, log)
