"""Scan-mode engine: batched backward-search matching statistics + LCP
shortening (port of ``slamem_tpu/engine/scan_mode.py``).

Thousands of lanes (one per query chunk of ``lane_block`` positions) run the
reference's right-to-left state machine in lockstep: backward-extend with
occ lookups, and on failure climb parent LCP intervals until the step
succeeds.

  * the match depth is CAPPED at L (the minimum match length). The capped
    state at position i — the SA interval of the longest prefix of
    q[i:i+L] that occurs in the reference — is a pure function of the L
    characters ahead, so a lane warming up for L positions before its chunk
    is EXACT: no saturation repair, no cross-chunk dependence;
  * shortening uses the branchless PSV/NSV pyramid (kernels/lcp_search.py);
  * every occ query goes through the rank kernel (kernels/rank.py) unless
    ``Config.rank_kernel`` says otherwise;
  * the per-position intervals at depth exactly L feed the shared
    pair-expansion / diagonal-run backend (engine/seed_mode.py).
"""

from __future__ import annotations

import numpy as np
import torch

from slamem_tpu_torch.config import Config
from slamem_tpu_torch.engine import seed_mode
from slamem_tpu_torch.index.build import FMIndex, rank_batch
from slamem_tpu_torch.index.lcp import lcp_adjacent
from slamem_tpu_torch.io.fasta import CODE_N
from slamem_tpu_torch.kernels.lcp_search import (LcpPyramid, expand,
                                                 parent_depth)
from slamem_tpu_torch.kernels.rank import (interleaved_rows, rank_rows,
                                           rank_rows_plain)

# Chunk width for chr-scale scans. The capped-depth state at position i is
# a pure function of q[i:i+L] (the module-docstring exactness argument), so
# the scan may process any slice of the query given L characters of
# lookahead — intervals are identical to the monolithic scan's. Chunks bound
# the lane state and the per-step working set.
_SCAN_CHUNK = 1 << 22


def get_pyramid(index: FMIndex) -> LcpPyramid:
    """LCP pyramid of an index, built once per index."""
    pyr = index.derived.get("lcp_pyramid")
    if pyr is None:
        pyr = index.derived["lcp_pyramid"] = LcpPyramid.build(
            lcp_adjacent(index.text, index.sa))
    return pyr


def _occ_fn(index: FMIndex, rank_kernel: str):
    """Batched occ(c, j) closure for a ``Config.rank_kernel`` value."""
    if rank_kernel in ("auto", "pallas"):
        rows = interleaved_rows(index)
        return lambda chars, positions: rank_rows(rows, chars, positions)
    if rank_kernel == "pallas_interpret":
        rows = interleaved_rows(index)
        return lambda chars, positions: rank_rows_plain(rows, chars,
                                                        positions)
    if rank_kernel == "xla":
        return lambda chars, positions: rank_batch(index, chars, positions)
    if rank_kernel == "nib":
        raise NotImplementedError(
            "rank_kernel='nib' (nibble-SWAR table) is not ported yet "
            "(ROADMAP A4: nibble-SWAR rank layout)")
    raise ValueError(f"unknown rank_kernel {rank_kernel!r}")


def _backward(index: FMIndex, occ_fn, c: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    cc = c.clamp(0, 3)
    occ = occ_fn(torch.cat([cc, cc]), torch.cat([lo, hi]))
    k = lo.shape[0]
    base = index.counts[cc.to(torch.int64)]
    return base + occ[:k], base + occ[k:]


def _scan_lanes(index: FMIndex, pyr: LcpPyramid, occ_fn, qt: torch.Tensor,
                L: int, lane_block: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lockstep capped-MS scan; returns (lo, width) at depth L per position.

    Lane g owns positions [g*B, (g+1)*B) and starts L positions to their
    right (warm-up). Step s visits column S-1-s of every lane; from step L
    on, that column is in the lane's own block and is recorded. The inner
    loop runs until no lane is pending, one host read per iteration.
    """
    m = qt.shape[0]
    n = index.n
    B = lane_block
    C = -(-m // B)                      # lanes
    S = B + L                           # steps per lane (L warm-up)
    dev = qt.device
    i32 = dict(dtype=torch.int32, device=dev)
    # codes by position, N past the end (lanes there are not live)
    qpad = torch.full((C * B + L,), CODE_N, **i32)
    qpad[:m] = qt
    lane_start = torch.arange(C, **i32) * B

    l = torch.zeros(C, **i32)
    r = torch.full((C,), n, **i32)
    d = torch.zeros(C, **i32)
    depth_cap = torch.full((C,), L - 1, **i32)
    out_lo = torch.zeros((C, B), **i32)
    out_w = torch.zeros((C, B), **i32)

    for step in range(S):
        col = S - 1 - step
        i = lane_start + col
        live = i < m
        c = qpad[i]

        # pre-expansion: a depth-L state must drop to depth L-1 before the
        # next prepend so the cap is preserved
        at_cap = live & (d == L)
        el, er = expand(pyr, l, r, depth_cap)
        l = torch.where(at_cap, el, l)
        r = torch.where(at_cap, er, r)
        d = torch.where(at_cap, L - 1, d)

        pending = live
        while bool(pending.any()):
            l2, r2 = _backward(index, occ_fn, c, l, r)
            ok = (c < 4) & (l2 < r2)
            succ = pending & ok
            dead = pending & ~ok & (d == 0)
            shorten = pending & ~ok & (d > 0)
            pd = parent_depth(pyr, l, r)
            sl, sr = expand(pyr, l, r, pd)
            l = torch.where(succ, l2, torch.where(
                dead, 0, torch.where(shorten, sl, l)))
            r = torch.where(succ, r2, torch.where(
                dead, n, torch.where(shorten, sr, r)))
            d = torch.where(succ, d + 1, torch.where(
                dead, 0, torch.where(shorten, pd, d)))
            pending = shorten

        if step >= L:
            out_lo[:, col] = l
            out_w[:, col] = torch.where(d == L, r - l, 0)
    return out_lo.view(-1)[:m], out_w.view(-1)[:m]


def scan_intervals(index: FMIndex, query_text: np.ndarray | torch.Tensor,
                   L: int, lane_block: int = 256, rank_kernel: str = "auto"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position SA intervals of q[i:i+L] (width 0 where absent), int32
    on the index's device."""
    if not isinstance(query_text, torch.Tensor):
        query_text = torch.from_numpy(
            np.ascontiguousarray(query_text, dtype=np.uint8))
    qt = query_text.to(device=index.device, dtype=torch.uint8)
    return _scan_lanes(index, get_pyramid(index),
                       _occ_fn(index, rank_kernel), qt, L, lane_block)


def find_scan_matches(index: FMIndex, query_text: np.ndarray,
                      cfg: Config) -> seed_mode.SeedMatches:
    """Scan frontend + shared pair/run backend (see seed_mode)."""
    L = cfg.min_length
    # N-padding: no spurious intervals
    qp, qt = seed_mode.query_to_device(query_text, index.device)
    m = int(qp.shape[0])
    C = _SCAN_CHUNK
    los, ws = [], []
    for a in range(0, m, C):
        lo_c, w_c = scan_intervals(index, qt[a:a + C + L], L,
                                   rank_kernel=cfg.rank_kernel)
        take = min(C, m - a)
        los.append(lo_c[:take])
        ws.append(w_c[:take])
    lo = torch.cat(los)
    width = torch.cat(ws)
    # FM hits never touch specials: the plain SA is the all-valid view
    return seed_mode.pairs_to_matches(index, lo, width, L, m, cfg, index.sa)
