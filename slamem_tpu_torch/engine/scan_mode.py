"""Scan-mode engine: batched backward-search matching statistics + LCP
shortening (port of ``slamem_tpu/engine/scan_mode.py``).

Thousands of lanes (one per query chunk of ``lane_block`` positions) run the
reference's right-to-left state machine: backward-extend with occ lookups,
and on failure climb parent LCP intervals until the step succeeds.

  * the match depth is CAPPED at L (the minimum match length). The capped
    state at position i — the SA interval of the longest prefix of
    q[i:i+L] that occurs in the reference — is a pure function of the L
    characters ahead, so a lane warming up for L positions before its chunk
    is EXACT: no saturation repair, no cross-chunk dependence;
  * shortening uses the PSV/NSV pyramid (kernels/lcp_search.py);
  * ``scan_intervals`` routes on ``Config.rank_kernel`` and the index's
    device. On a CUDA index, "auto" and "nib" launch the scan kernel
    ``kernels.rank.scan_lanes`` on the nibble table and "pallas" on the
    interleaved (K0) table: one launch per call, one warp per lane running
    every step, the occ rows and the pyramid read inside. "pallas_interpret"
    and "xla" on any device, and every value on the CPU, run the plain
    lockstep loop ``_scan_lanes`` (the reference the kernel is held to),
    with the occ closure of ``_occ_fn``: on the CPU the rank wrappers take
    their plain versions. These are explicit plain paths, as the JAX
    package's ``_want_pallas`` names them; any other value runs as
    "auto" does there;
  * the per-position intervals at depth exactly L feed the shared
    pair-expansion / diagonal-run backend (engine/seed_mode.py).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from slamem_tpu_torch.config import Config
from slamem_tpu_torch.engine import seed_mode
from slamem_tpu_torch.index.build import FMIndex, rank_batch
from slamem_tpu_torch.index.lcp import lcp_adjacent
from slamem_tpu_torch.io.fasta import CODE_N
from slamem_tpu_torch.kernels.lcp_search import (LcpPyramid, expand,
                                                 parent_depth)
from slamem_tpu_torch.kernels.rank import (interleaved_rows, nibble_rows,
                                           rank_rows, rank_rows_nib,
                                           rank_rows_nib_plain,
                                           rank_rows_plain, scan_lanes)
from slamem_tpu_torch.utils.log import engine_stages, span

# Chunk width for chr-scale scans. The capped-depth state at position i is
# a pure function of q[i:i+L] (the module-docstring exactness argument), so
# the scan may process any slice of the query given L characters of
# lookahead — intervals are identical to the monolithic scan's. Chunks bound
# the lane state and the per-step working set.
_SCAN_CHUNK = 1 << 22


def get_pyramid(index: FMIndex, stats: dict | None = None) -> LcpPyramid:
    """LCP pyramid of an index, built once per index; a build fills
    ``stats`` as ``lcp_adjacent`` does (``long_pairs``: the pairs its
    second pass took, ``launches``: its kernel launches, 0 on the CPU)."""
    pyr = index.derived.get("lcp_pyramid")
    if pyr is None:
        pyr = index.derived["lcp_pyramid"] = LcpPyramid.build(
            lcp_adjacent(index.text, index.sa, stats))
    return pyr


# the occ table the scan reads for a Config.rank_kernel value: its
# FMIndex.derived key, the function that builds it and the count over it
# (_occ_fn's resolution: "xla" reads the occ checkpoints, no table; a
# value not named here the nibble table)
_SCAN_TABLES = {"pallas": ("rank_rows", interleaved_rows, rank_rows),
                "pallas_interpret": ("rank_rows", interleaved_rows,
                                     rank_rows_plain),
                "xla": None}
_NIB_TABLE = ("rank_rows_nib", nibble_rows, rank_rows_nib)


def _occ_fn(index: FMIndex, rank_kernel: str):
    """Batched occ(c, j) closure for a ``Config.rank_kernel`` value, resolved
    as the JAX package's ``_want_pallas``: "pallas" = the interleaved table
    and K0, "pallas_interpret" = K0's plain version, "xla" = rank_batch over
    the occ checkpoints, and every other value ("auto", "nib", or one the
    package does not name) = the nibble table and its kernel."""
    table = _SCAN_TABLES.get(rank_kernel, _NIB_TABLE)
    if table is None:
        return lambda chars, positions: rank_batch(index, chars, positions)
    _, build, count = table
    rows = build(index)
    return lambda chars, positions: count(rows, chars, positions)


def _backward(index: FMIndex, occ_fn, c: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    cc = c.clamp(0, 3)
    occ = occ_fn(torch.cat([cc, cc]), torch.cat([lo, hi]))
    k = lo.shape[0]
    base = index.counts[cc.to(torch.int64)]
    return base + occ[:k], base + occ[k:]


@dataclasses.dataclass
class ScanTrace:
    """What the lanes of ``_scan_lanes`` read, as the scan kernel reads it
    (for the chip check's counts of attempts and sectors): per inner
    iteration the number of pending lanes (backward-extend attempts); the
    (l, r) of each attempt that reads rank rows (c < 4), one (2, k) int32
    tensor an iteration; the (l, r, v, shortening) of each expansion, one
    (4, k) int32 tensor a pass: a pre-expansion at the depth cap
    (shortening 0), or a shortening after a failed attempt (1), which also
    reads LCP[l] and LCP[r]."""

    attempts: list[int] = dataclasses.field(default_factory=list)
    occ: list[torch.Tensor] = dataclasses.field(default_factory=list)
    expand: list[torch.Tensor] = dataclasses.field(default_factory=list)

    def add_expansions(self, at: torch.Tensor, l: torch.Tensor,
                       r: torch.Tensor, v: torch.Tensor,
                       shortening: int) -> None:
        """Record the expansions of lanes ``at``: (l, r) to depth v."""
        if bool(at.any()):
            va = v[at]
            self.expand.append(torch.stack(
                [l[at], r[at], va, torch.full_like(va, shortening)]))


def _scan_lanes(index: FMIndex, pyr: LcpPyramid, occ_fn, qt: torch.Tensor,
                L: int, lane_block: int, trace: ScanTrace | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lockstep capped-MS scan; returns (lo, width) at depth L per position.

    Lane g owns positions [g*B, (g+1)*B) and starts L positions to their
    right (warm-up). Step s visits column S-1-s of every lane; from step L
    on, that column is in the lane's own block and is recorded. The inner
    loop runs until no lane is pending, one host read per iteration. A
    ``trace`` receives what the lanes read (``ScanTrace``).
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
        if trace is not None:
            trace.add_expansions(at_cap, l, r, depth_cap, 0)
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
            if trace is not None:
                trace.attempts.append(int(pending.sum()))
                reads = pending & (c < 4)
                trace.occ.append(torch.stack([l[reads], r[reads]]))
                trace.add_expansions(shorten, l, r, pd, 1)
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


def scan_lanes_plain(rows: torch.Tensor, layout: str, counts: torch.Tensor,
                     pyr: LcpPyramid, qt: torch.Tensor, L: int,
                     lane_block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``kernels.rank.scan_lanes``: the lockstep loop
    over the layout's plain occ ("k0": ``rank_rows_plain``, "nib":
    ``rank_rows_nib_plain``), given what the kernel is given."""
    plain = rank_rows_plain if layout == "k0" else rank_rows_nib_plain
    # _scan_lanes reads only n and C[] of the index
    index = types.SimpleNamespace(n=pyr.n, counts=counts)
    return _scan_lanes(index, pyr, lambda chars, positions: plain(
        rows, chars, positions), qt, L, lane_block)


# the table layout on which the scan kernel runs for a Config.rank_kernel
# value on a CUDA index: "pallas" = K0, the plain values none, every other
# value the nibble table (_occ_fn's resolution)
_KERNEL_LAYOUT = {"pallas": "k0", "pallas_interpret": None, "xla": None}


def scan_intervals(index: FMIndex, query_text: np.ndarray | torch.Tensor,
                   L: int, lane_block: int = 256, rank_kernel: str = "auto"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position SA intervals of q[i:i+L] (width 0 where absent), int32
    on the index's device (routing: the module docstring)."""
    if not isinstance(query_text, torch.Tensor):
        query_text = torch.from_numpy(
            np.ascontiguousarray(query_text, dtype=np.uint8))
    qt = query_text.to(device=index.device, dtype=torch.uint8).contiguous()
    layout = _KERNEL_LAYOUT.get(rank_kernel, "nib")
    if layout is not None and index.device.type == "cuda":
        rows = _SCAN_TABLES.get(rank_kernel, _NIB_TABLE)[1](index)
        return scan_lanes(rows, layout, index.counts, get_pyramid(index), qt,
                          L, lane_block)
    return _scan_lanes(index, get_pyramid(index),
                       _occ_fn(index, rank_kernel), qt, L, lane_block)


def find_scan_matches(index: FMIndex, query_text: np.ndarray, cfg: Config,
                      mesh=None) -> seed_mode.SeedMatches:
    """Scan frontend + shared pair/run backend (see seed_mode); ``mesh``
    goes on to the backend, as in the JAX package. Stages ``upload``;
    where the index has not cached them, ``scan_lcp`` (the LCP array and
    its pyramid: ``n``, and ``lcp_adjacent``'s ``long_pairs`` and
    ``launches``) and ``scan_rows`` (the occ table of
    ``cfg.rank_kernel``: ``rows``, ``bytes``); ``frontend`` (the scan:
    ``chunks``, ``launches`` of the scan kernel); then the backend's."""
    L = cfg.min_length
    with engine_stages(index.device, cfg.verbose) as stage_s:
        with span("upload"):
            # N-padding: no spurious intervals
            qp, qt = seed_mode.query_to_device(query_text, index.device)
        if "lcp_pyramid" not in index.derived:
            with span("scan_lcp", n=index.n) as rec:
                get_pyramid(index, rec)
        table = _SCAN_TABLES.get(cfg.rank_kernel, _NIB_TABLE)
        if table is not None and table[0] not in index.derived:
            with span("scan_rows") as rec:
                rows = table[1](index)
                rec.update(rows=int(rows.shape[0]),
                           bytes=rows.numel() * rows.element_size())
        with span("frontend") as rec:
            launched = sum(scan_lanes.launches.values())
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
            rec.update(chunks=len(los), launches=sum(
                scan_lanes.launches.values()) - launched)
        # FM hits never touch specials: the plain SA is the all-valid view
        matches = seed_mode.pairs_to_matches(index, lo, width, L, m, cfg,
                                             index.sa, qt=qt, mesh=mesh)
    matches.stats["stage_s"] = stage_s
    return matches
