"""ctypes binding of the port's native 2-bit packer (``pack2.c``).

The library is built by gcc at first use (``build_gcc``); a failed build
raises. ``utils/pack2.py::pack_codes_2bit_plain`` (numpy) and
``np.flatnonzero`` have the same contract and are what the tests hold this
one to.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from slamem_tpu_torch._native import build_gcc

_SOURCE = Path(__file__).parent / "pack2.c"
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_gcc(_SOURCE, "pack2")))
    lib.pack_codes_2bit.restype = ctypes.c_long
    lib.pack_codes_2bit.argtypes = [_U8P, ctypes.c_long, ctypes.c_long, _U8P,
                                    _I32P, ctypes.c_long]
    return lib


def _args(qp: np.ndarray, out: np.ndarray | None
          ) -> tuple[np.ndarray, np.ndarray]:
    qp = np.ascontiguousarray(qp, dtype=np.uint8)
    if qp.ndim != 1 or qp.size % 4 or qp.size >= 2**31:
        raise ValueError(f"codes must be 1-D, fewer than 2^31, with a length "
                         f"divisible by 4; got shape {qp.shape}")
    if out is None:
        out = np.empty(qp.size // 4, np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (qp.size // 4,)
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writeable contiguous uint8 array of "
                         f"{qp.size // 4} bytes, got {out.dtype} {out.shape}")
    return qp, out


def pack_codes_2bit(qp: np.ndarray, out: np.ndarray | None = None
                    ) -> np.ndarray:
    """4 codes per byte, low code first (bits 0, 2, 4, 6), into ``out``
    (a contiguous uint8 array of ``qp.size // 4`` bytes, e.g. the numpy
    view of a pinned tensor) or a new array; returns it."""
    qp, out = _args(qp, out)
    _lib().pack_codes_2bit(qp.ctypes.data_as(_U8P), qp.size, 0,
                           out.ctypes.data_as(_U8P), None, -1)
    return out


def pack_codes_2bit_specials(qp: np.ndarray, m_real: int, cap: int,
                             out: np.ndarray | None = None
                             ) -> np.ndarray | None:
    """``pack_codes_2bit`` into ``out`` and, in the same pass, the
    positions p < m_real with qp[p] >= 4, ascending, as int32; None (the
    plane unfinished) when they are more than ``cap``."""
    qp, out = _args(qp, out)
    idx = np.empty(max(cap, 0), np.int32)    # pages touched only as written
    s = _lib().pack_codes_2bit(qp.ctypes.data_as(_U8P), qp.size, m_real,
                               out.ctypes.data_as(_U8P),
                               idx.ctypes.data_as(_I32P), cap)
    return None if s > cap else idx[:s]
