"""ctypes binding of the port's native listing renderer (``matchfmt.c``).

The library is built by gcc at first use (``build_gcc``); a failed build
raises. The Python renderer of ``report/format.py`` gives the same bytes and
is what the tests hold this one to.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from slamem_tpu_torch._native import build_gcc

_SOURCE = Path(__file__).parent / "matchfmt.c"
_I64P = ctypes.POINTER(ctypes.c_int64)
# buffer bytes per line besides the name column: a line takes at most 69
# (three int64 fields of up to 20 characters, the gaps and the newline),
# and the C loop wants 64 free bytes plus the name's before each line
_LINE_BYTES = 80


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_gcc(_SOURCE, "matchfmt")))
    lib.fmt_lines_single.restype = ctypes.c_long
    lib.fmt_lines_single.argtypes = [_I64P, _I64P, _I64P, ctypes.c_long,
                                     ctypes.c_char_p, ctypes.c_long]
    lib.fmt_lines_multi.restype = ctypes.c_long
    lib.fmt_lines_multi.argtypes = [_I64P, _I64P, _I64P, _I64P, ctypes.c_long,
                                    ctypes.c_char_p, _I64P, _I64P,
                                    ctypes.c_char_p, ctypes.c_long]
    return lib


def _i64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def render_single(rp: np.ndarray, qp: np.ndarray, ln: np.ndarray) -> bytes:
    """Single-reference lines (1-based positions already applied)."""
    n = int(rp.size)
    if n == 0:
        return b""
    rp, qp, ln = _i64(rp), _i64(qp), _i64(ln)
    cap = _LINE_BYTES * n
    out = ctypes.create_string_buffer(cap)
    w = _lib().fmt_lines_single(rp.ctypes.data_as(_I64P),
                                qp.ctypes.data_as(_I64P),
                                ln.ctypes.data_as(_I64P), n, out, cap)
    if w < 0:
        raise ValueError("matchfmt buffer overflow")
    return out.raw[:w]


def render_multi(seq: np.ndarray, rp: np.ndarray, qp: np.ndarray,
                 ln: np.ndarray, names: list[str]) -> bytes:
    """Multi-reference lines; ``names`` come padded to the column's width
    (the caller pads by characters) and are copied as they are."""
    n = int(rp.size)
    if n == 0:
        return b""
    seq, rp, qp, ln = _i64(seq), _i64(rp), _i64(qp), _i64(ln)
    if int(seq.min()) < 0 or int(seq.max()) >= len(names):
        raise ValueError("reference sequence ids out of range")
    name_bytes = [nm.encode() for nm in names]
    name_len = np.array([len(b) for b in name_bytes], dtype=np.int64)
    name_off = _i64(np.cumsum(name_len) - name_len)
    cap = (_LINE_BYTES + int(name_len.max())) * n
    out = ctypes.create_string_buffer(cap)
    w = _lib().fmt_lines_multi(
        seq.ctypes.data_as(_I64P), rp.ctypes.data_as(_I64P),
        qp.ctypes.data_as(_I64P), ln.ctypes.data_as(_I64P), n,
        b"".join(name_bytes), name_off.ctypes.data_as(_I64P),
        name_len.ctypes.data_as(_I64P), out, cap)
    if w < 0:
        raise ValueError("matchfmt buffer overflow")
    return out.raw[:w]
