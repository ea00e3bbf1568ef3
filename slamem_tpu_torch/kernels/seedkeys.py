"""Loader of the K-mer key kernels (``csrc/seedkeys.cu``: the seed table's
rows and the sampled windows' keys, one window packer behind two C
entries). The wrappers and their plain versions are
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
    seed_table: ctypes._CFuncPtr       # slamem_seed_table
    pack_keys: ctypes._CFuncPtr        # slamem_pack_keys
    path: Path
    build_log: str


@functools.cache
def load_kernel() -> _Kernel:
    """Build (once per source and flags) and load the key kernels."""
    path, log = build_nvcc(_SOURCE, "seedkeys")
    lib = ctypes.CDLL(str(path))
    seed_table, pack_keys = lib.slamem_seed_table, lib.slamem_pack_keys
    seed_table.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p]
    pack_keys.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p]
    seed_table.restype = pack_keys.restype = ctypes.c_int
    return _Kernel(seed_table, pack_keys, path, log)
