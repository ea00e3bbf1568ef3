"""Loader of the K-mer key kernels (``csrc/seedkeys.cu``: the seed table's
plane pass and gather, and the sampled windows' keys, one window packer
behind three C entries). The wrappers and their plain versions are
``engine/seed_mode.seed_table_rows`` and ``packed_key_words``. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

from slamem_tpu_torch.kernels import build_nvcc

_SOURCE = Path(__file__).parent / "csrc" / "seedkeys.cu"


class _Kernel(NamedTuple):
    seed_plane: ctypes._CFuncPtr       # slamem_seed_plane
    seed_gather: ctypes._CFuncPtr      # slamem_seed_gather
    pack_keys: ctypes._CFuncPtr        # slamem_pack_keys
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the key kernels."""
    path, log = build_nvcc(_SOURCE, "seedkeys")
    lib = ctypes.CDLL(str(path))
    plane, gather = lib.slamem_seed_plane, lib.slamem_seed_gather
    pack_keys = lib.slamem_pack_keys
    plane.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_void_p]
    gather.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    pack_keys.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p]
    plane.restype = gather.restype = pack_keys.restype = ctypes.c_int
    return _Kernel(plane, gather, pack_keys, path, log)
