"""Loader of the window-key kernel of the index build's suffix sort
(``csrc/sakeys.cu``: the first 27 characters of every suffix as one base-5
int64). The wrapper and its plain version are ``index/build.sa_keys`` and
``sa_keys_plain``. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

from slamem_tpu_torch.kernels import build_nvcc

_SOURCE = Path(__file__).parent / "csrc" / "sakeys.cu"


class _Kernel(NamedTuple):
    fn: ctypes._CFuncPtr       # slamem_sa_keys
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the window-key kernel."""
    path, log = build_nvcc(_SOURCE, "sakeys")
    fn = ctypes.CDLL(str(path)).slamem_sa_keys
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _Kernel(fn, path, log)
