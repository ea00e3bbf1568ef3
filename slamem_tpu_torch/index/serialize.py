"""Index save/load (port of ``slamem_tpu/index/serialize.py``).

The same versioned npz as the JAX package, with the same array dtypes, so an
index saved by either package loads in the other. ``index_from_numpy`` is
also how the JAX package's index arrays (taken to numpy) become this
package's FMIndex.
"""

from __future__ import annotations

import numpy as np
import torch

from slamem_tpu_torch.index.build import FMIndex
from slamem_tpu_torch.utils.device import resolve_device

FORMAT_VERSION = 1

_DTYPES = {"text": np.uint8, "sa": np.int32, "bwt": np.uint8,
           "occ_ckpt": np.int32, "counts": np.int32}


def save_index(path: str, index: FMIndex) -> None:
    np.savez_compressed(
        path,
        version=np.int64(FORMAT_VERSION),
        occ_block=np.int64(index.occ_block),
        **{k: getattr(index, k).cpu().numpy() for k in _DTYPES},
    )


def index_from_numpy(arrays, occ_block: int,
                     device: str | torch.device) -> FMIndex:
    """FMIndex on ``device`` from host arrays (text, sa, bwt, occ_ckpt,
    counts), checked against the format's dtypes and shapes.

    Integer arrays of another width are taken when every value survives
    the cast: the JAX package, with x64 on, holds ``counts`` as int64.
    """
    dev = resolve_device(device)
    fields = {}
    for k, dt in _DTYPES.items():
        a = np.asarray(arrays[k])
        if a.dtype != dt:
            cast = a.astype(dt)
            if a.dtype.kind not in "iu" or not np.array_equal(cast, a):
                raise ValueError(f"index array {k!r} has dtype {a.dtype}, "
                                 f"expected {np.dtype(dt)}")
            a = cast
        # a copy: the index must not alias (possibly read-only) host arrays
        fields[k] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    n = fields["text"].shape[0]
    n_blocks = -(-n // int(occ_block))
    if (fields["sa"].shape != (n,) or fields["bwt"].shape != (n,)
            or fields["occ_ckpt"].shape != (n_blocks + 1, 4)
            or fields["counts"].shape != (4,)):
        raise ValueError("index arrays have inconsistent shapes")
    return FMIndex(occ_block=int(occ_block), **fields)


def load_index(path: str, device: str | torch.device) -> FMIndex:
    with np.load(path) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"index file {path!r} has format version {version}, "
                f"this build reads version {FORMAT_VERSION}")
        return index_from_numpy(z, int(z["occ_block"]), device)
