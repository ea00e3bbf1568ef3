"""Loader of the bucket-start kernel (``csrc/buckets.cu``, the boundary
fill). The wrapper and its plain version are
``engine/seed_mode.bucket_starts`` and ``bucket_starts_plain``. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

from slamem_tpu_torch.kernels import build_nvcc

_SOURCE = Path(__file__).parent / "csrc" / "buckets.cu"


class _Kernel(NamedTuple):
    fn: ctypes._CFuncPtr       # slamem_bucket_starts
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the bucket-start kernel."""
    path, log = build_nvcc(_SOURCE, "buckets")
    fn = ctypes.CDLL(str(path)).slamem_bucket_starts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _Kernel(fn, path, log)
