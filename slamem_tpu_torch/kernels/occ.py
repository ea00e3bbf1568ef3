"""Loader of the occ checkpoint kernel (``csrc/occ.cu``: count the BWT's
tiles, scan the tiles' totals, write every checkpoint row). The wrapper
and its plain version are ``index/build.occ_checkpoints`` and
``occ_checkpoints_plain``. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

from slamem_tpu_torch.kernels import build_nvcc

_SOURCE = Path(__file__).parent / "csrc" / "occ.cu"


class _Kernel(NamedTuple):
    fn: ctypes._CFuncPtr       # slamem_occ_checkpoints
    tiles: ctypes._CFuncPtr    # slamem_occ_tiles: the scratch's int4 count
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the occ kernel."""
    path, log = build_nvcc(_SOURCE, "occ")
    lib = ctypes.CDLL(str(path))
    fn, tiles = lib.slamem_occ_checkpoints, lib.slamem_occ_tiles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tiles.argtypes = [ctypes.c_int64]
    tiles.restype = ctypes.c_int64
    return _Kernel(fn, tiles, path, log)
