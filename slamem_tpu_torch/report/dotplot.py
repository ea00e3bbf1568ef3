"""BMP dot-plot of matches (port of ``slamem_tpu/report/dotplot.py``;
capability parity with graphics.c, SURVEY.md §2).

Rasterizes each match as a diagonal segment (reference position on x, query
position on y; reverse-strand matches in a second color) into a 24-bit BMP
written with plain numpy — no imaging dependency, same spirit as the
reference's self-contained BMP writer.
"""

from __future__ import annotations

import struct

import numpy as np

from slamem_tpu_torch.engine.run import EngineOutput

_FWD = (180, 40, 40)    # forward matches
_REV = (40, 40, 180)    # reverse-complement matches
_AXIS = (120, 120, 120)


def _rasterize(out: EngineOutput, ref_len: int, query_len: int,
               size: int, ref_starts: np.ndarray | None = None) -> np.ndarray:
    img = np.full((size, size, 3), 255, np.uint8)
    img[0, :, :] = _AXIS
    img[-1, :, :] = _AXIS
    img[:, 0, :] = _AXIS
    img[:, -1, :] = _AXIS
    sx = (size - 1) / max(ref_len, 1)
    sy = (size - 1) / max(query_len, 1)
    for qm in out.per_query:
        if qm.length.size == 0:
            continue
        color = _REV if qm.reverse else _FWD
        for k in range(qm.length.size):
            ln = int(qm.length[k])
            npts = max(2, min(ln, 4 * size))
            t = np.linspace(0.0, ln - 1, npts)
            # per-seq ref coords -> global x axis via sequence start offsets
            roff = (int(ref_starts[int(qm.ref_seq[k])])
                    if ref_starts is not None else 0)
            x = ((roff + qm.ref_pos[k] + t) * sx).astype(np.int32)
            y = ((qm.q_pos[k] + t) * sy).astype(np.int32)
            img[np.clip(y, 0, size - 1), np.clip(x, 0, size - 1)] = color
    return img


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB array as an uncompressed 24-bit BMP."""
    h, w, _ = img.shape
    row_bytes = (w * 3 + 3) & ~3
    data_size = row_bytes * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", 14 + 40 + data_size, 0, 0, 14 + 40,
        40, w, h, 1, 24, 0, data_size, 2835, 2835, 0, 0)
    rows = np.zeros((h, row_bytes), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up, BGR
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows.tobytes())


def write_dotplot(path: str, out: EngineOutput, ref_len: int, query_len: int,
                  size: int = 1024, ref_starts: np.ndarray | None = None
                  ) -> None:
    write_bmp(path, _rasterize(out, ref_len, query_len, size, ref_starts))
