"""The 2-bit packed upload wire (port of ``slamem_tpu/utils/pack2.py``).

DNA codes are 0..5 (io/fasta.py): ACGT in 2 bits plus rare specials (N = 4,
SEP = 5). The wire ships a 2-bit plane (4 codes per byte) plus a sparse
(index, value) side channel for the specials, and one device program
rebuilds the exact uint8 codes. The query upload
(``engine/seed_mode.query_to_device``) and the reference upload of a numpy
text of >= 2^20 codes (``index/build.build_index``) ride it.

Host half: one pass of the C packer (``_native/pack2.c``) writes the
plane straight into a pinned host buffer and finds the specials; their
side channel ``[int32 indices | uint8 values]`` goes into a second, small
pinned buffer. Each goes to the card in one non-blocking copy on the
current stream. Device half: ``unpack_codes``, the hand-written CUDA kernel
of ``kernels/csrc/unpack2.cu`` on CUDA tensors and ``unpack_codes_plain``
on CPU tensors. A failed build or launch raises; nothing falls back to the
plain unpack or a plain copy. The one route to a plain copy is the JAX
package's rule, chosen by the data: more than max(16, m_real // 8)
specials, where the side channel would rival the plane, makes
``codes_to_device`` return None.
"""

from __future__ import annotations

import numpy as np
import torch

from slamem_tpu_torch._native import pack2n
from slamem_tpu_torch.io.fasta import CODE_N
from slamem_tpu_torch.kernels.unpack2 import load_kernel
from slamem_tpu_torch.utils.device import resolve_device


def pack_codes_2bit(qp: np.ndarray, out: np.ndarray | None = None
                    ) -> np.ndarray:
    """4 codes per byte, low code first (bits 0, 2, 4, 6), by the C packer
    (built by gcc at first use; raises without it), into ``out`` or a new
    array. The length must be a multiple of 4; only the low 2 bits of each
    code survive (N -> A, SEP -> C), the side channel restores them."""
    return pack2n.pack_codes_2bit(qp, out)


def pack_codes_2bit_plain(qp: np.ndarray) -> np.ndarray:
    """``pack_codes_2bit`` in numpy: the SWAR over a uint32 view (the JAX
    package's fallback). The tests hold the C packer to it."""
    qp = np.ascontiguousarray(qp, dtype=np.uint8)
    if qp.__array_interface__["data"][0] % 4:
        qp = qp.copy()            # 4-byte-align for the uint32 view
    w = qp.view(np.uint32)
    w = w & np.uint32(0x03030303)                # c0@0, c1@8, c2@16, c3@24
    w = (w | (w >> 6)) & np.uint32(0x000F000F)   # c0|c1<<2 @0, c2|c3<<2 @16
    w = (w | (w >> 12)) & np.uint32(0xFF)        # all four in bits 0..7
    return w.astype(np.uint8)


def unpack_codes_plain(pb: torch.Tensor, spec_idx: torch.Tensor,
                       spec_val: torch.Tensor, m_real: int) -> torch.Tensor:
    """Inverse of the pack in plain PyTorch: codes (4 * len(pb),) uint8
    with CODE_N at every position >= m_real, then spec_val scattered to
    spec_idx; indices outside [0, 4 * len(pb)) are dropped (the JAX
    scatter's mode="drop"). The reference the kernel is held to."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=pb.device)
    codes = ((pb[:, None] >> shifts[None, :]) & 3).reshape(-1)
    pos = torch.arange(codes.numel(), device=pb.device)
    codes = torch.where(pos >= m_real, torch.tensor(
        CODE_N, dtype=torch.uint8, device=pb.device), codes)
    keep = (spec_idx >= 0) & (spec_idx < codes.numel())
    codes[spec_idx[keep].long()] = spec_val[keep]
    return codes


def _check(pb: torch.Tensor, spec_idx: torch.Tensor,
           spec_val: torch.Tensor) -> None:
    """Argument check of ``unpack_codes`` from shapes, dtypes and pointers
    alone (no read of the data)."""
    for name, t, dtype in (("pb", pb, torch.uint8),
                           ("spec_idx", spec_idx, torch.int32),
                           ("spec_val", spec_val, torch.uint8)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D contiguous {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != pb.device:
            raise ValueError(f"{name} is on {t.device}, pb on {pb.device}")
    if spec_idx.shape != spec_val.shape:
        raise ValueError(f"spec_idx {tuple(spec_idx.shape)} and spec_val "
                         f"{tuple(spec_val.shape)} differ in shape")
    if pb.device.type == "cuda" and pb.data_ptr() % 4:
        raise ValueError("pb must be 4-byte aligned on the card")


def unpack_codes(pb: torch.Tensor, spec_idx: torch.Tensor,
                 spec_val: torch.Tensor, m_real: int) -> torch.Tensor:
    """Device half of the wire: (4 * len(pb),) uint8 codes, as
    ``unpack_codes_plain``. The indices of ``spec_idx`` must be distinct.

    CUDA tensors run the kernels of ``kernels/csrc/unpack2.cu`` on the
    current stream, without synchronising: one call is one launch (the
    dense pass) or two (then the specials' scatter), counted once in
    ``unpack_codes.launches``. CPU tensors take ``unpack_codes_plain``.
    """
    _check(pb, spec_idx, spec_val)
    if pb.device.type == "cpu":
        return unpack_codes_plain(pb, spec_idx, spec_val, m_real)
    out = torch.empty(4 * pb.numel(), dtype=torch.uint8, device=pb.device)
    if pb.numel() == 0:
        return out
    fn = load_kernel().fn
    with torch.cuda.device(pb.device):
        stream = torch.cuda.current_stream(pb.device).cuda_stream
        err = fn(pb.data_ptr(), pb.numel(), spec_idx.data_ptr(),
                 spec_val.data_ptr(), spec_idx.numel(), int(m_real),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"unpack kernel launch failed: CUDA error {err}")
    unpack_codes.launches += 1
    return out


unpack_codes.launches = 0


def pack_wire(codes_padded: np.ndarray, m_real: int, pin: bool
              ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """The host half: (plane, side channel) uint8 buffers (pinned if
    ``pin``) of codes whose length is a multiple of 4; the side channel is
    ``[int32 indices | uint8 values]`` of the specials of
    ``codes_padded[:m_real]``. One C pass packs the plane and finds the
    specials; None if they are more than max(16, m_real // 8)."""
    codes_padded = np.ascontiguousarray(codes_padded, dtype=np.uint8)
    plane = torch.empty(codes_padded.size // 4, dtype=torch.uint8,
                        pin_memory=pin)
    spec = pack2n.pack_codes_2bit_specials(
        codes_padded, m_real, max(16, m_real // 8), plane.numpy())
    if spec is None:
        return None
    s = spec.size
    side = torch.empty(5 * s, dtype=torch.uint8, pin_memory=pin)
    sv = side.numpy()
    sv[:4 * s].view(np.int32)[:] = spec
    sv[4 * s:] = codes_padded[spec]
    return plane, side


def split_side(side: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(indices, values) views of a side channel ``[int32 | uint8]``."""
    s = side.numel() // 5
    return side[:4 * s].view(torch.int32), side[4 * s:]


def codes_to_device(codes_padded: np.ndarray, m_real: int,
                    device: str | torch.device) -> torch.Tensor | None:
    """Exact uint8 codes on ``device`` by the packed wire, or None for a
    special-dense input (the caller then makes the plain upload).

    On a card the host buffers are pinned and copied without blocking on
    the current stream (the caching host allocator keeps a block until its
    copy has run); the caller's next synchronising read waits for them.
    """
    dev = resolve_device(device)
    wire = pack_wire(codes_padded, m_real, pin=dev.type == "cuda")
    if wire is None:
        return None
    plane, side = (t.to(dev, non_blocking=True) for t in wire)
    return unpack_codes(plane, *split_side(side), m_real)
