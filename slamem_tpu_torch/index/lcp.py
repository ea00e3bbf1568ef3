"""LCP array construction (port of ``slamem_tpu/index/lcp.py``).

LCP[j] = lcp(sa[j-1], sa[j]) by direct comparison of the two suffixes'
characters: the first LCP_WINDOW characters of every adjacent pair at
once, then the pairs still equal on all of them a window further, and so
on. On the card this is one kernel (``kernels/csrc/lcp.cu``): one thread a
pair for the first window, and one warp a pair, 512 characters a step, for
the few pairs that get past it.

Semantics, as the JAX package's rank descent has them: codes >= 4 (N, a
separator, the terminator) are specials, which match nothing, themselves
included; a position at or past the text's end counts as a special, so the
prefix stops there too. No cap on the length.
"""

from __future__ import annotations

import torch

from slamem_tpu_torch.io.fasta import CODE_N
from slamem_tpu_torch.kernels.lcp import load_kernel

LCP_WINDOW = 32          # characters compared a pass (the kernel's first)
PLAIN_BLOCK = 1 << 22    # pairs the plain version compares at a time


def _window_prefix(codes: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Per pair: how many of the LCP_WINDOW characters from a and from b
    are alike before the first that differs or is a special; LCP_WINDOW
    where none does. ``codes`` is the text with LCP_WINDOW specials
    after its end."""
    off = torch.arange(LCP_WINDOW, device=codes.device)
    ca = codes[a[:, None] + off]
    cb = codes[b[:, None] + off]
    bad = (ca != cb) | (ca >= CODE_N)
    return torch.where(bad.any(1), bad.to(torch.int32).argmax(1),
                       LCP_WINDOW)


def lcp_adjacent_plain(text: torch.Tensor, sa: torch.Tensor,
                       stats: dict | None = None) -> torch.Tensor:
    """lcp_adjacent by torch ops, the kernel's arithmetic: a window of
    LCP_WINDOW characters a pass, first over every pair, then over the
    pairs still alike on every character so far, PLAIN_BLOCK pairs at a
    time. ``stats`` as lcp_adjacent's, with
    ``launches`` 0."""
    n = int(sa.numel())
    dev = sa.device
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    codes = torch.cat([text, torch.full((LCP_WINDOW,), CODE_N,
                                        dtype=torch.uint8, device=dev)])
    long_pairs = 0
    for s in range(1, n, PLAIN_BLOCK):
        e = min(n, s + PLAIN_BLOCK)
        a = sa[s - 1:e - 1].to(torch.int64)
        b = sa[s:e].to(torch.int64)
        h = _window_prefix(codes, a, b)
        live = (h == LCP_WINDOW).nonzero()[:, 0]
        long_pairs += live.numel()
        while live.numel():
            # a live pair is alike on every character before h, so a + h
            # and b + h lie at most at the text's end
            run = _window_prefix(codes, a[live] + h[live], b[live] + h[live])
            h[live] += run
            live = live[run == LCP_WINDOW]
        out[s:e] = h.to(torch.int32)
    if stats is not None:
        stats.update(long_pairs=long_pairs, launches=0)
    return out


def lcp_adjacent(text: torch.Tensor, sa: torch.Tensor,
                 stats: dict | None = None) -> torch.Tensor:
    """LCP[j] = lcp(suffix sa[j-1], suffix sa[j]); LCP[0] = 0. int32 (n,).

    ``text`` is 1-D contiguous uint8 codes, ``sa`` 1-D contiguous int32
    positions in it, on the same device. CUDA tensors launch
    ``kernels/csrc/lcp.cu`` on the current stream: ``slamem_lcp_first``
    (every pair's first LCP_WINDOW characters; the pairs equal on all of
    them go to a list), then, after one scalar read of the list's length,
    ``slamem_lcp_long`` where it is not empty; each launch counts in
    ``lcp_adjacent.launches``; fewer than 2 rows launch nothing. CPU
    tensors take lcp_adjacent_plain. ``stats``, where given, receives
    ``long_pairs`` (the pairs equal on their first LCP_WINDOW characters)
    and ``launches`` (this call's).
    """
    if text.dtype != torch.uint8 or text.dim() != 1 or \
            not text.is_contiguous():
        raise ValueError(f"text must be a 1-D contiguous uint8 tensor, got "
                         f"{tuple(text.shape)} {text.dtype}")
    if sa.dtype != torch.int32 or sa.dim() != 1 or not sa.is_contiguous() \
            or sa.device != text.device:
        raise ValueError(f"sa must be a 1-D contiguous int32 tensor on "
                         f"{text.device}, got {tuple(sa.shape)} {sa.dtype} "
                         f"on {sa.device}")
    if text.device.type == "cpu":
        return lcp_adjacent_plain(text, sa, stats)
    n = sa.numel()
    long_pairs = launches = 0
    if n <= 1:
        lcp = torch.zeros(n, dtype=torch.int32, device=sa.device)
    else:
        kernel = load_kernel()
        lcp = torch.empty(n, dtype=torch.int32, device=sa.device)
        longs = torch.empty(n, dtype=torch.int32, device=sa.device)
        count = torch.zeros(1, dtype=torch.int32, device=sa.device)
        with torch.cuda.device(sa.device):
            stream = torch.cuda.current_stream(sa.device).cuda_stream
            err = kernel.first(text.data_ptr(), text.numel(), sa.data_ptr(),
                               n, lcp.data_ptr(), longs.data_ptr(),
                               count.data_ptr(), stream)
            launches = 1
            if err == 0:
                long_pairs = int(count)
                if long_pairs:
                    err = kernel.long(text.data_ptr(), text.numel(),
                                      sa.data_ptr(), lcp.data_ptr(),
                                      longs.data_ptr(), long_pairs, stream)
                    launches = 2
        if err != 0:
            raise RuntimeError(f"LCP kernel launch failed: CUDA error {err}")
        lcp_adjacent.launches += launches
    if stats is not None:
        stats.update(long_pairs=long_pairs, launches=launches)
    return lcp


lcp_adjacent.launches = 0
