"""Loader of the 2-bit unpack kernels (``csrc/unpack2.cu``: the dense pass
and the specials' scatter, behind one C entry), the device half of the
packed upload wire. The wrapper, its plain version and the host half are in
``utils/pack2.py``. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

from slamem_tpu_torch.kernels import build_nvcc

_SOURCE = Path(__file__).parent / "csrc" / "unpack2.cu"


class _Kernel(NamedTuple):
    fn: ctypes._CFuncPtr       # slamem_unpack_codes
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the unpack kernel."""
    path, log = build_nvcc(_SOURCE, "unpack2")
    fn = ctypes.CDLL(str(path)).slamem_unpack_codes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _Kernel(fn, path, log)
