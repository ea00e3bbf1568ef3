"""Chip check of the PyTorch port (``slamem_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases, each of which raises on failure (exit status non-zero):
  1. build the kernel libraries from the checkout, one nvcc (sm_90a) per
     source, all started together: the rank library (csrc/rank.cu: the
     standalone K0 and nibble kernels and the scan kernel on both layouts),
     the unpack kernel of the packed upload wire (csrc/unpack2.cu), the
     endpoint-extension kernel of the seed engine (csrc/extend.cu), the key
     kernels of the seed tables (csrc/seedkeys.cu: the seed table's rows
     and the query's key pack), the bucket-start kernel (csrc/buckets.cu),
     the index build's occ checkpoint and window-key kernels
     (csrc/occ.cu, csrc/sakeys.cu) and the scan engine's LCP kernel
     (csrc/lcp.cu);
  o. the occ checkpoint kernel (index/build.py occ_checkpoints) on a BWT
     of chr1's 250,000,001 symbols at occ_block 128 == its plain version,
     aligned and 1 byte past a 16-byte boundary (the byte path), timed
     with its byte bound, the plain version, the plain version with its
     cumsum along the contiguous dimension, and the library yardstick:
     torch.cumsum of the block counts along the contiguous dimension (and
     along the outer one, the parent's call);
  k. the suffix sort's window-key kernel (index/build.py sa_keys) at
     chr1's 250,000,001 symbols == sa_keys_plain on the chr1 cells' kind
     of text (N runs, SEP last), aligned and 1 byte past a 16-byte
     boundary, and on one with a special at one position in 240, timed
     with its byte bound (n read, 8 n written) and the plain version;
  2. hold each standalone rank kernel against its plain PyTorch version,
     exact integer equality, and time both: K0 (rank_rows, interleaved
     table) and the nibble kernel (rank_rows_nib, nibble table), each on
     the 5 Mbp headline reference's table with >= 4M random (c, j) queries
     plus the row-edge positions, at the old scan batch shape (32,768
     queries), and on a random 200 M-symbol table larger than L2, each
     with its bound (bytes: the distinct 32-byte sectors under each
     query's counter word and the symbol words its nearer-side count
     needs, chars, positions and out; operations: 8 a counted nibble
     word, 16 a K0 word) and the up-side bound (every query counting up
     from its row's counter) beside it; then the turn edges of both tables
     (per_row/2 - 1, per_row/2, per_row/2 + 1 of every row, the last
     row's upper half past n) == plain;
     2w. the index-level drop-ins for rank_batch, each == rank_batch
         exactly, on the headline index (phase 2's random queries in
         [0, n] plus every row edge of every table below) and on an index
         over phase 2's 200 M-symbol BWT (its random queries): rank_nib
         at 128, 512, 2048, 4096 and 130 words a row (128: the 128-word
         nibble kernel; the other widths: the any-width kernel, one launch
         a call), rank_pallas (K0) and rank_xla (the plain row gather, no
         kernel); the launches of that run are counted; then at each
         width the turn edges == plain (those <= n through every drop-in
         == rank_batch), and each kernel == its plain version, timed by
         CUDA events (raw launch; plain: the one cold call that gives the
         reference) with its nearer-side bound and the up-side bound
         beside it; backward_step on the card over 4,096 random
         20-mers of the headline reference == the same steps on a CPU copy
         of the index, every 20-mer found; and examples/demo_torch.py
         run on the card (its save/load and 4-slab listings identical);
     u. the 2-bit packed upload wire (utils/pack2.py) at config #5's
        sizes, numpy codes from a seed: its 250,000,000-code reference
        (an N run, separators) and a 50 Mbp query of 10 entries padded to
        its bucket (50,003,968 codes): codes_to_device == the host codes
        and the unpack kernel == unpack_codes_plain on the card, byte for
        byte; times of the whole wire, its host pass (the C pass that
        packs into pinned memory and finds the specials; numpy's scan for
        the specials beside it), the pinned copies, the kernel (bound: n/4
        + 5 s + n bytes) and the plain unpack, against a pageable and a
        pinned plain copy of the codes; then the edge cases (specials at
        0 and m_real - 1, a ragged last plane word, none, the 1/8 gate,
        and past it and a half-N query, which take the plain copy and
        launch nothing) and the kernel == unpack_codes_plain at plane
        lengths around its word, warp and block edges (UNPACK_NB), with
        no special, one, the edge ones and one in eight positions;
     2s. the scan kernel (scan_lanes, one warp per lane) on one full 4M
         chunk of the headline query (strain_pair(5_000_000,
         seed=20260816, sub_rate=0.015, indel_rate=0.0015)) at ``-l 20``,
         on each table layout, against the plain lockstep loop
         (scan_mode._scan_lanes with the layout's plain occ) on the card:
         lo and width exactly equal; kernel time by CUDA events after a
         warm-up, the plain run's time and its count of backward-extend
         attempts and expansions, the bound (its operations on the symbol
         words each occ needs from its nearer counter) with the first
         design's whole-row bound beside it, the sectors the kernel
         touches (counted from the plain run's trace of positions, for
         the whole-row design and this one) with their bound, and a latency
         estimate;
  3. the scan slice end to end through the CLI, ``-engine scan -l 20
     -device cuda``, on the headline pair: the listing must hold exactly
     59,101 MEMs (the count the JAX package records in BENCH_DETAIL.json),
     every one an exact maximal match, and the run (rank_kernel "auto",
     which resolves to the nibble table as in the JAX package) must have
     launched the scan kernel on the nibble table once per 4M chunk and no
     standalone rank kernel;
     3k. the same pair through run_engine with ``rank_kernel="pallas"``:
         the scan kernel on the K0 table once per chunk, no standalone
         rank kernel, and listing bytes equal to phase 3's;
     3p. a warm 5 Mbp scan (index built, one call before) under
         torch.profiler: the device's busy share of the call;
  4. a ~200 kbp multi-FASTA pair with N runs through ``-b``, ``-b -mum`` and
     ``-b -mam``: the listing bytes on ``-device cuda`` and ``-device cpu``
     must be identical;
     4o. each of those listings holds exactly the brute-force oracle's
         matches (slamem_tpu_torch.oracle, numpy, every diagonal of every
         (query, strand) entry, spread over the host's cores): nothing is
         missing and nothing is extra;
     4k. the same input through run_engine with ``rank_kernel="pallas"``
         on the card, MEM/MUM/MAM, both strands: the run must have
         launched the scan kernel on the K0 table, and the listing bytes
         must equal phase 4's (nibble) scan bytes;
  5. the default engine (seed: K-mer frontend, sparse seeding, endpoint
     extension), through the CLI without ``-engine``, on ``-device cuda``,
     at the bench's sizes, each listing holding exactly the JAX package's
     count (BENCH_DETAIL.json):
     5a. the headline pair at ``-l 20``: 59,101 MEMs, exact and maximal,
         byte-identical to phase 3's scan listing;
     5b. the same pair with ``-mam -l 20``: 59,083;
     5c. ``strain_pair(40_000_000, ...)`` (same seed and rates) at
         ``-l 50``: 286,645, exact and maximal (the chr21-scale stand-in);
     3c. the same 40 Mbp pair through ``-engine scan -l 50 -device cuda``
         (10 chunks; its LCP array, 160 MB, is larger than L2): 286,645,
         listing bytes == 5c's; then the scan frontend's split, cold on a
         fresh index: the LCP array (with its long pairs and launches),
         its pyramid, the nibble table and the 10 scan launches, each
         timed apart;
     5d. the headline reference against 10 strains
         ``mutate(ref, 0.01 + 0.001 j, 0.001, seed=100 + j)`` as one
         multi-FASTA query at ``-l 30``: 478,358;
     5e. phase 4's input through ``-b``, ``-b -mum`` and ``-b -mam``: GPU
         bytes == CPU bytes.
     5a-5d print the plan (K, stride, frontend, rounds), index build and
     query seconds, each stage's device-synchronised seconds (the CLI's
     ``-v`` line) and peak device memory; 5a must have launched the
     unpack kernel exactly twice (the reference and the query uploads);
     each of 5a-5d, 6a, 6b, 9a and 9b must have launched the extension
     kernel exactly once and built no extension table (ext_arrays) on the
     card (a tap stands in for seed_mode.extend_runs and ext_arrays and
     calls them; it also keeps 5d's and 6a's merged runs for phase e);
     each CLI call of 5a-5d, 6a, 6b and 9a must have launched the seed
     table's kernel once, the key pack once, the index build's occ
     checkpoint and window-key kernels once each (its cold build; each
     also logs the suffix sort's sorts) and the bucket-start kernel
     once (5a-5c, 6a, 9a), never (5d, the join frontend) or once a slab
     (6b: 8);
     t. the seed tables' kernels against their plain versions on the card,
        exact, timed by CUDA events (raw launches, wrapper, plain), each
        with its bound: at the 5 Mbp index after 5d the seed table at 5a's
        K (13) and 5d's (14), 5a's direct bucket table (2^26 + 1 entries)
        and 5a's query's key pack (K 13, stride 8), and two-word keys (K =
        20: seed table, bucket table with shift 8 and probes); at config
        #5's index after 9b the seed table (K 14), 6a's direct bucket
        table (2^28 + 1), 6b's 8 ranged slab tables (R = 2^26) and 6a's
        query's key pack (K 14, stride 14). Each seed table also times its
        plane pass and its gather alone and counts the rows sent to the
        exact path and the 32-byte sectors under the windows in the text
        and in the plane (its sector bounds). The bucket tables also
        against torch.searchsorted of the rows' prefixes over every bucket
        (equal, timed: the library yardstick), beside a streaming
        yardstick of the same bytes (a sum over the keys and a fill of
        the table) and, for one table, the old cold path
        (_build_bucket_table over _key_word0): with the plain seed table,
        the split of the old ``tables`` stage; each also logs its largest
        bucket and its widest gaps;
  7. the boundary match backend (``Config(match_backend="boundary")``,
     dense seeding at stride 1) through run_engine on the card:
     7a. the headline pair at ``-l 20``: 59,101, bytes == 5a's listing;
     7b. the 40 Mbp pair at ``-l 50``: 286,645, bytes == 5c's listing, at
         the default pair capacity and at 2^24 (several rounds);
     7c. phase 4's input with ``-b``, MEM/MUM/MAM, seed and scan engines:
         GPU bytes == CPU bytes == the sort backend's bytes;
     7d. the same input (seed, MEM) at a pair capacity of 4,096: several
         rounds, bytes == one round's.
     7a and 7b print the plan (K, stride, rounds, pairs), stage seconds and
     peak device memory;
  8. the native host paths at 5c and 6a sizes: read_fasta (C parser) ==
     parse_fasta_bytes (numpy) and format_matches (C) ==
     format_matches_python (bytes, and == the CLI's listing), each timed;
  6. BASELINE config #5 (the bench's chr1-scale pair: reference
     ``strain_pair(250_000_000, seed=20260816, sub_rate=0.03,
     indel_rate=0.003)``, query its strain's first 50,000,000 codes) at
     ``-l 50`` on ``-device cuda``, each listing holding exactly the JAX
     package's 307,706 MEMs (BENCH_DETAIL.json chr1_250mbp_l50 and
     chr1_sharded_250mbp_l50):
     6a. the default call (replicated index), every match exact and
         maximal;
     6b. ``-shard -slabs 8`` (the 8-slab program on the one card):
         listing bytes == 6a's;
     6s. ``-engine scan`` (``-v``): listing bytes == 6a's, one scan
         launch a 4M chunk, the LCP kernel's launches == its span's;
         prints the scan_lcp, scan_rows and frontend stages'
         device-synchronised seconds and fields (scan_lcp's long pairs
         and launches) and the peak device memory; then lcp_adjacent ==
         benchmark/reference/lcp.py's lcp_plain over the 250,000,001 rows
         and the first and last chunks' scan intervals == its
         intervals_plain, exactly; the LCP kernel's time by CUDA events
         (both passes, raw launches), the wrapper's and the plain
         version's (lcp_adjacent_plain), beside its byte bound (the text,
         sa and lcp each once) and its sector bound (sa and lcp, and the
         32-byte sectors under each suffix's first 32 characters and
         under the long pairs' further characters) (also alone, on the
         benchmark's inputs for a seed: ``python3 chip_smoke.py
         --scan-chr1 [--bench-seed N]``);
     6c. phase 4's input through ``-shard -slabs 3 -b``, ``-b -mum`` and
         ``-b -mam``: GPU bytes == CPU bytes == the default call's bytes
         (5e), and ``-shard -b`` alone == the default call.
     6a and 6b print the plan (K, stride, slabs, shift, probes, R, rounds,
     pairs), index build and query seconds, stage seconds, peak device
     memory and the card's name and power limit; 6a's peak must not pass
     15,559,308,288 B (14.491 GiB: every chr1 run's peak when the suffix
     sort started from 1-character ranks);
  9. the mesh (dist/) on the card at world size 1 over NCCL:
     9a. the CLI under the launcher variables (JAX_COORDINATOR_ADDRESS =
         127.0.0.1:<free port>, JAX_NUM_PROCESSES=1, JAX_PROCESS_ID=0; it
         joins a one-rank NCCL group, rank 0 on cuda:0) on the headline
         pair at ``-l 20``, plain and with ``-shard``: 59,101 each, bytes
         == 5a's;
     9b. config #5's index built alone: its seconds, sorts and own peak
         device memory (over what is held before it); then config #5
         (phase 6's files) through the replicated engine
         (seed_mode.find_seed_matches) and the one-slab-per-rank branch
         (sharded.find_seed_matches_sharded_mesh), each given that
         group's one-rank mesh, so their gathers and reductions run over
         NCCL on the card: 307,706 each, listing bytes == 6a's; each
         prints its stage seconds (``gather`` = the collectives), rounds,
         pairs, peak device memory and the card's name and power limit.
  e. the extension kernel (seed_mode.extend_runs) against its plain
     version (_extend_core over ext_arrays of both texts) on the card,
     exact, on the merged, span-filtered runs that 5d's and 6a's calls
     extended, on edge triples over the same texts (run boundaries at
     and beyond both text edges, beside specials, random) and on window
     triples (every window at every distance 0..33 from both ends of both
     texts), the edge and window triples also with both texts copied to
     byte offsets 0..15 of larger buffers; times of the raw launch, the
     wrapper, the plain version and its core alone by CUDA events, the
     bound from the runs' bytes and the sector bound (40 B a run + the
     32-byte sectors under its four windows).
Phases run in the order 1, o, k, 2, 2w, u, 2s, 3, 3k, 3p, 4 with 5e, 4o, 4k, 7c,
7d, 5a, 9a, 7a, 5b, 5d, t (5 Mbp), 5c, 3c, 7b, 8 (5c), 6c, 6a, 8 (6a), 6b,
6s, 9b, t (config #5), e. Prints the card and its power limit (nvidia-smi), a
``{"kernels": [...]}`` line (each kernel's launches on its path,
exactness, time, plain time and lower bound; the standalone rank kernels'
path is the scan kernel that runs their device function, the any-width
nibble kernel's is 2w's rank_nib calls; the unpack,
extension, table, occ and window-key kernels' launches are 5a's, their
times phase u's at the query shape, phase e's at 6a's runs, phase t's at
6a's shapes and phases o's and k's at chr1's size; the LCP kernel's
launches and time are 6s's),
and last ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HEADLINE = dict(n=5_000_000, seed=20260816, sub_rate=0.015,
                indel_rate=0.0015)
HEADLINE_L = 20
HEADLINE_MATCHES = 59_101        # BENCH_DETAIL.json headline_5mbp_l20.matches
MAM_MATCHES = 59_083             # config3_mam_l20.matches
CHR21 = dict(HEADLINE, n=40_000_000)
CHR21_L = 50
CHR21_MATCHES = 286_645          # chr21_40mbp_l50.matches
STRAINS = 10
STRAINS_L = 30
STRAINS_MATCHES = 478_358        # config2_10strains_l30.matches
CHR1 = dict(HEADLINE, n=250_000_000, sub_rate=0.03, indel_rate=0.003)
CHR1_QUERY_BP = 50_000_000
CHR1_L = 50
CHR1_SLABS = 8
CHR1_MATCHES = 307_706           # chr1_250mbp_l50.matches (== sharded)
WIRE_N_RUN = slice(100_000_000, 100_050_000)  # phase u's reference N run
# phase u's plane lengths (bytes) around the unpack kernel's word (4 B),
# warp (128 words) and block (1,024 words) edges
UNPACK_NB = (1, 2, 3, 5, 15, 16, 17, 63, 64, 65, 4095, 4096, 4097, 16385,
             70_001)
RANDOM_QUERIES = 1 << 22         # 4,194,304 random occ queries
# a pair capacity under 5c's dense pair total (31M at K=16) but over a
# third of it, so the rounds do not grow to pair_capacity_max: 2 rounds
BOUNDARY_ROUNDS_CAPACITY = 1 << 24
ROW_BYTES = 512                  # one table row per query (both layouts)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
# peak scalar rate: 67 TFLOP/s float32 outside the tensor cores (NVIDIA data
# sheet); the integer pipes are no faster, so ops / this rate is a lower
# bound on the time of integer work
SCALAR_OPS_PER_S = 67e12
# assumed time of one dependent L2 round trip of a warp, with the warp's
# work between two loads (for the latency estimate only; the measured
# time per round trip is printed beside it)
ROUND_TRIP_US = 0.5


def _log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms, by CUDA events around reps calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _turns(fns: dict, reps: int) -> dict:
    """Mean device times (ms) of each of ``fns`` in turns: every one, then
    every one again in reverse order; the mean of the two."""
    got = {name: [] for name in fns}
    order = list(fns)
    for names in (order, order[::-1]):
        for name in names:
            got[name].append(_cuda_ms(fns[name], reps))
    return {name: sum(v) / len(v) for name, v in got.items()}


def _kernel_vs_plain(rank, name: str, rows, chars, positions,
                     label: str) -> dict:
    """Exact check of a rank wrapper (``rank_rows`` or ``rank_rows_nib``)
    against its plain version, then times: the raw kernel launch, the
    wrapper (with its argument checks) and plain; and the kernel's lower
    bound on this input (``_sector_bound``: the sectors and words each
    query's nearer-side count needs), with the up-side bound (every query
    counting up from its row's counter) beside it."""
    import torch

    wrapper = getattr(rank, name)
    plain = getattr(rank, name + "_plain")
    got = wrapper(rows, chars, positions)
    want = plain(rows, chars, positions)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{name} {label}: kernel != plain (max abs err "
                             f"{err})")
    kernel = rank.load_kernel()
    nib = name == "rank_rows_nib"
    fn = kernel.nib_fn if nib else kernel.fn
    out = torch.empty_like(positions)
    nq = positions.numel()
    nrows = int(rows.shape[0])
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        if fn(rows.data_ptr(), chars.data_ptr(), positions.data_ptr(),
              out.data_ptr(), nq, nrows, stream):
            raise RuntimeError(f"{name} launch failed")

    ms = _cuda_ms(raw, 50)
    wrapper_ms = _cuda_ms(lambda: wrapper(rows, chars, positions), 20)
    plain_ms = _cuda_ms(lambda: plain(rows, chars, positions), 5)
    words = int(rows.shape[1]) - rank.CNT_WORDS
    syms_per_row = words * (8 if nib else 4)
    touched = int(torch.unique(torch.div(
        positions, syms_per_row, rounding_mode="floor")).numel())
    row_bytes = int(rows.shape[1]) * 4
    # per symbol word: nib xor, and, add, or, andnot, mask, popc, add (8);
    # K0 extract, compare, position test, add per byte (4 x 4)
    ops_per_word = 8 if nib else 16
    bound = _sector_bound(rows, chars, positions, 8 if nib else 4,
                          ops_per_word)
    up = _sector_bound(rows, chars, positions, 8 if nib else 4, ops_per_word,
                       nearer=False)
    gbps = row_bytes * nq / (ms * 1e-3) / 1e9
    plain_gbps = row_bytes * nq / (plain_ms * 1e-3) / 1e9
    _log(f"[rank] {name} {label}: {nq} queries, table {rows.numel() * 4} B "
         f"({touched} rows touched); kernel {ms:.6f} ms ({gbps:.2f} GB/s at "
         f"{row_bytes} B/query), wrapper {wrapper_ms:.6f} ms, plain "
         f"{plain_ms:.6f} ms ({plain_gbps:.2f} GB/s); bound "
         f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: "
         f"{bound['sectors']} sectors, {bound['bound_ops']} ops; nearer "
         f"side), up side {up['bound_ms']:.6f} ms ({up['bound_by']}: "
         f"{up['sectors']} sectors, {up['bound_ops']} ops); exact")
    return {"queries": nq, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "gb_per_s": gbps, "max_abs_err": err,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "sectors": bound["sectors"], "up_bound_ms": up["bound_ms"]}


def _turn_edges(n: int, nrows: int, per_row: int, device):
    """Positions where a standalone kernel's count turns: per_row/2 - 1,
    per_row/2 and per_row/2 + 1 of every row (up to down), and up to 64
    of the last row's upper half past n (which counts up), each with every
    c: (chars, positions) int32."""
    import torch

    half = torch.arange(nrows, device=device) * per_row + per_row // 2
    past = torch.arange(max(n + 1, int(half[-1]) - 1), nrows * per_row,
                        device=device)
    past = past[torch.linspace(0, past.numel() - 1, min(past.numel(), 64),
                               device=device).long()]
    pos = torch.cat([half - 1, half, half + 1, past]).to(torch.int32)
    return (torch.arange(4, dtype=torch.int32, device=device).repeat(
        pos.numel()), pos.repeat_interleave(4))


def _edges_exact(rank, name: str, rows, n: int, per_row: int,
                 label: str) -> int:
    """Phase 2's turn edges (``_turn_edges``) through a standalone kernel's
    wrapper == its plain version; returns their count."""
    chars, positions = _turn_edges(n, int(rows.shape[0]), per_row,
                                   rows.device)
    _exact(f"2 {name} {label} turn edges",
           (getattr(rank, name)(rows, chars, positions),),
           (getattr(rank, name + "_plain")(rows, chars, positions),))
    return int(positions.numel())


def _bwt_index(bwt):
    """An FMIndex over a bare BWT of random symbols: what rank_batch and
    the rank tables read of an index (the BWT, its occ checkpoints every
    128 symbols, n). No text or suffix array stands behind it."""
    import torch

    from slamem_tpu_torch.index.build import FMIndex

    n, block = bwt.numel(), 128
    nb = -(-n // block)
    padded = torch.cat([bwt, torch.full((nb * block - n,), 6,
                                        dtype=torch.uint8,
                                        device=bwt.device)]).view(nb, block)
    per_block = torch.stack([(padded == c).sum(1, dtype=torch.int32)
                             for c in range(4)], dim=1)
    occ = torch.cat([torch.zeros((1, 4), dtype=torch.int32,
                                 device=bwt.device),
                     torch.cumsum(per_block, 0, dtype=torch.int32)])
    return FMIndex(text=bwt, sa=bwt[:0].to(torch.int32), bwt=bwt,
                   occ_ckpt=occ, counts=occ[-1], occ_block=block)


def _sector_bound(rows, chars, positions, syms_per_word: int,
                  ops_per_word: int, nearer: bool = True) -> dict:
    """Bound of a row count (nibble table of any width: 8 symbols a word,
    K0: 4) on these queries: bytes = the distinct 32-byte sectors holding
    a query's counter word or one of its counted symbol words (each read
    once) + chars, positions and out (12 B a query); operations =
    ``ops_per_word`` a counted symbol word. ``nearer`` (the standalone
    kernels' count): a position in its row's upper half, outside the
    table's last row, counts the words from the one that holds it to the
    row's end, from the next row's counter; any other counts the words
    below it, from its row's counter. Else every query counts up (the
    up-side figure)."""
    import torch

    width = int(rows.shape[1])
    nw = width - 4
    per_row = nw * syms_per_word
    p, c = positions.long(), chars.long()
    b = torch.div(p, per_row, rounding_mode="floor")
    w = p - b * per_row
    up_hi = (w + syms_per_word - 1) // syms_per_word
    down = (w >= per_row // 2) & (b < rows.shape[0] - 1) if nearer else \
        torch.zeros_like(p, dtype=torch.bool)
    lo = torch.where(down, w // syms_per_word, 0)
    hi = torch.where(down, nw, up_hi)
    base = rows.data_ptr() % 32
    row = base + b * width * 4                     # byte of the row
    nsec = (base + rows.numel() * 4 + 31) // 32
    hit = torch.zeros(nsec + 1, dtype=torch.int32, device=p.device)
    has = hi > lo
    first = (row + 16 + 4 * lo) // 32
    last = (row + 16 + 4 * hi - 1) // 32
    ones = torch.ones_like(first, dtype=torch.int32)
    hit.index_add_(0, first[has], ones[has])
    hit.index_add_(0, last[has] + 1, -ones[has])
    covered = torch.cumsum(hit, 0)[:nsec] > 0
    covered[(row + down * width * 4 + 4 * c) // 32] = True  # the counters
    sectors = int(covered.sum())
    out = _bound(32 * sectors + 12 * p.numel(),
                 ops_per_word * int((hi - lo).sum()))
    out["sectors"] = sectors
    return out


def _phase_2w(rank, build, pack2, tables: dict) -> dict:
    """Phase 2w on each of ``tables`` (label -> (index, chars,
    positions)): every drop-in == rank_batch, the counts set to 0 just
    before and read just after (the main path of the any-width kernel);
    then at each width the turn edges (``_turn_edges``) == plain (and,
    those <= n, every drop-in == rank_batch), and each kernel == its
    plain version, timed, with its bound."""
    import torch

    _reset_launches(rank, pack2)
    for label, (index, chars, positions) in tables.items():
        want = build.rank_batch(index, chars, positions)
        for name, call in _drop_ins(rank, index, chars, positions):
            _exact(f"2w {label} {name}", (call(),), (want,))
        del want
    torch.cuda.synchronize()
    launches = {"rank_rows_nib_any": rank.rank_rows_nib.any_launches,
                "rank_rows_nib": rank.rank_rows_nib.launches,
                "rank_rows": rank.rank_rows.launches}
    n_any = len(tables) * (len(NIB_WIDTHS) - 1)
    if launches != {"rank_rows_nib_any": n_any,
                    "rank_rows_nib": len(tables), "rank_rows": len(tables)}:
        raise AssertionError(f"2w: launches {launches}; expected "
                             f"{n_any} any-width, {len(tables)} 128-word "
                             f"nibble and {len(tables)} K0")
    _log(f"[2w] rank_nib at {NIB_WIDTHS} words, rank_pallas and rank_xla "
         f"== rank_batch on {', '.join(tables)}; launches {launches}")
    stream = torch.cuda.current_stream().cuda_stream
    kernel = rank.load_kernel()
    out = {"launches": launches}
    for label, (index, chars, positions) in tables.items():
        turns = []   # each width's turn edges <= n
        for w in NIB_WIDTHS + ("k0",):
            rows = rank.interleaved_rows(index) if w == "k0" else \
                rank.nibble_rows(index, w)
            plain = rank.rank_rows_plain if w == "k0" else \
                rank.rank_rows_nib_plain
            fn, extra = ((kernel.fn, ()) if w == "k0" else
                         (kernel.nib_fn, ()) if w == rank.ROW_WORDS else
                         (kernel.nib_any_fn, (w,)))
            nrows = int(rows.shape[0])

            def launch(c, p, res):
                if fn(rows.data_ptr(), c.data_ptr(), p.data_ptr(),
                      res.data_ptr(), p.numel(), nrows, *extra, stream):
                    raise RuntimeError(f"2w {label} {w}: launch failed")
                return res

            # the turn edges of this table (the last row's past n too)
            per_row = rank.SYMS_PER_ROW if w == "k0" else \
                rank._nib_per_row(w)
            tc, tp = _turn_edges(index.n, nrows, per_row, positions.device)
            _exact(f"2w {label} {w} turn edges",
                   (launch(tc, tp, torch.empty_like(tp)),),
                   (plain(rows, tc, tp),))
            turns.append(tp[tp <= index.n])
            del tc, tp
            # one cold plain call, timed, gives the reference
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain(rows, chars, positions)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            res = torch.empty_like(positions)
            nq = positions.numel()

            def raw():
                launch(chars, positions, res)

            raw()
            err = _exact(f"2w {label} {w} kernel", (res,), (want,))
            ms = _cuda_ms(raw, 20)
            spw, opw = (4, 16) if w == "k0" else (8, 8)
            bound = _sector_bound(rows, chars, positions, spw, opw)
            up = _sector_bound(rows, chars, positions, spw, opw,
                               nearer=False)
            out[f"{label} {w}"] = rec = {
                "queries": nq, "ms": ms, "plain_ms": plain_ms,
                "max_abs_err": err, "table_bytes": rows.numel() * 4,
                **bound, "up_bound_ms": up["bound_ms"],
                "up_bound_by": up["bound_by"], "up_sectors": up["sectors"]}
            _log(f"[2w] {label}, {'K0' if w == 'k0' else f'nib {w} words'}"
                 f": {nq} queries, table {rec['table_bytes']} B; kernel "
                 f"{ms:.6f} ms, plain {plain_ms:.6f} ms (one cold call); "
                 f"bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}: "
                 f"{bound['sectors']} sectors, {bound['bound_ops']} ops; "
                 f"nearer side), up side {up['bound_ms']:.6f} ms "
                 f"({up['bound_by']}: {up['sectors']} sectors, "
                 f"{up['bound_ops']} ops); exact")
            del rows, want, res
        tp = torch.unique(torch.cat(turns))
        tc = torch.arange(4, dtype=torch.int32, device=tp.device).repeat(
            tp.numel())
        tp = tp.repeat_interleave(4)
        want = build.rank_batch(index, tc, tp)
        for name, call in _drop_ins(rank, index, tc, tp):
            _exact(f"2w {label} turn edges {name}", (call(),), (want,))
        _log(f"[2w] {label}: turn edges (half-row, last row past n) == "
             f"plain at every width; the {tp.numel()} (c, j) of those <= n "
             f"through every drop-in == rank_batch")
        del tc, tp, want, turns
    return out


# phase 2w's row widths of the nibble table: the engine's 128 words, the
# JAX package's bandwidth points and an odd width
NIB_WIDTHS = (128, 512, 2048, 4096, 130)


def _drop_ins(rank, index, chars, positions):
    """(name, call) of every index-level drop-in for rank_batch."""
    calls = [(f"rank_nib {w}", lambda w=w: rank.rank_nib(
        index, chars, positions, row_words=w)) for w in NIB_WIDTHS]
    return calls + [
        ("rank_pallas", lambda: rank.rank_pallas(index, chars, positions)),
        ("rank_xla", lambda: rank.rank_xla(index, chars, positions))]


def _backward_steps(build, serialize, index, ref, count: int = 4096,
                    k: int = 20) -> dict:
    """``count`` random k-mers of ``ref`` (ACGT only), searched by k
    backward_step calls on the card and on a CPU copy of the index: the
    intervals must be equal and every k-mer found."""
    import numpy as np
    import torch

    rng = np.random.default_rng(HEADLINE["seed"])
    starts = rng.integers(0, len(ref) - k, 4 * count)
    pats = ref[starts[:, None] + np.arange(k)]
    pats = torch.from_numpy(pats[(pats < 4).all(1)][:count].astype(np.int32))
    cpu = serialize.index_from_numpy(
        {f: getattr(index, f).cpu().numpy()
         for f in ("text", "sa", "bwt", "occ_ckpt", "counts")},
        index.occ_block, "cpu")
    got = {}
    for label, idx in (("cuda", index), ("cpu", cpu)):
        lo = torch.zeros(count, dtype=torch.int32, device=idx.device)
        hi = torch.full_like(lo, idx.n)
        for d in range(k - 1, -1, -1):
            lo, hi = build.backward_step(idx, pats[:, d].to(idx.device),
                                         lo, hi)
        got[label] = (lo.cpu(), hi.cpu())
    _exact("2w backward_step cuda vs cpu", got["cuda"], got["cpu"])
    width = got["cuda"][1] - got["cuda"][0]
    if pats.shape[0] != count or int(width.min()) < 1:
        raise AssertionError(f"2w backward_step: {pats.shape[0]} patterns, "
                             f"narrowest interval {int(width.min())}")
    _log(f"[2w] backward_step: {count} random {k}-mers of the reference, "
         f"{k} steps on the card == on the CPU; every one found "
         f"({int(width.sum())} occurrences, at most {int(width.max())})")
    return {"patterns": count, "occurrences": int(width.sum())}


def _demo(here: Path) -> dict:
    """examples/demo_torch.py on the card (its default device), as a user
    runs it: exit 0, the save/load and 4-slab listings identical."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(here / "examples" / "demo_torch.py")],
        cwd=here, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(here)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or \
            "byte-identical listing" not in proc.stdout:
        raise AssertionError(f"2w demo_torch.py exit {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    tail = proc.stdout.strip().splitlines()[-3:]
    _log(f"[2w] examples/demo_torch.py on the card: exit 0 in {wall:.3f} s;"
         f" {' | '.join(tail)}")
    return {"wall_s": wall}


def _row_sectors(j, per_row: int, per_chunk: int):
    """32-byte sectors the scan kernel's nearer-counter count reads at each
    position j (int64): up from row b's counter, its sector and those of
    chunks 1..ceil(w / per_chunk); down from the next row's (w in the
    row's upper half), the sectors of the chunks from w // per_chunk + 1
    to 31 and one counter sector (two chunks a sector)."""
    import torch

    w = j % per_row
    down = w >= per_row // 2
    up = (w + per_chunk - 1) // per_chunk // 2 + 1
    return torch.where(down, 16 - (w // per_chunk + 1) // 2 + 1, up)


def _row_words(j, per_row: int, words: int):
    """Symbol words of a rank row that the nearer-counter count needs at
    each position j (int64): those holding the symbols below w = j %
    per_row (w in the row's lower half), or those holding [w, per_row)
    (upper half), as ``_row_sectors`` splits the row."""
    import torch

    per_word = per_row // words
    w = j % per_row
    return torch.where(w >= per_row // 2, words - w // per_word,
                       (w + per_word - 1) // per_word)


def _pyramid_sectors(pyr, exp, batch: int = 1 << 17) -> tuple[int, int]:
    """32-byte sectors of the pyramid blocks that the expansions ``exp``
    ((4, E): l, r, v, shortening) read: (the whole-row design: whole blocks,
    the new one: in the ascent only the lanes' int4s on the position's
    side). Each side ascends while unresolved and descends through whole
    blocks, as ``csrc/rank.cu::expand_warp``; slots past a level's end and
    blocks left of 0 read nothing."""
    import torch

    F = 128
    idx = torch.arange(F, device=exp.device)
    old = new = 0
    sizes = [lv.numel() for lv in pyr.levels]

    def sectors(t, blk, lo, hi):
        a = (blk * F + lo).clamp(max=sizes[t])
        e = (blk * F + hi).clamp(max=sizes[t])
        return torch.where((blk >= 0) & (e > a), (e - 1) // 8 - a // 8 + 1,
                           0).sum()

    def block(t, blk):
        pos = blk[:, None] * F + idx[None, :]
        ok = (blk[:, None] >= 0) & (pos < sizes[t])
        vals = pyr.levels[t][pos.clamp(0, sizes[t] - 1)].to(torch.int64)
        return torch.where(ok, vals, 2**31 - 1)

    for s in range(0, exp.shape[1], batch):
        part = exp[:, s:s + batch].to(torch.int64)
        v = part[2]
        for left, pos in ((True, part[0]), (False, part[1])):
            level = torch.full_like(pos, -1)
            hit = torch.zeros_like(pos)
            for t in range(len(sizes)):
                act = level < 0
                if not bool(act.any()):
                    break
                blk = torch.div(pos, F, rounding_mode="floor")
                off = pos - blk * F
                side = idx[None, :] <= off[:, None] if left else \
                    idx[None, :] >= off[:, None]
                below = (block(t, blk) < v[:, None]) & side
                if left:
                    cand = torch.where(below, idx, -1).amax(1)
                    lo, hi = torch.zeros_like(off), off // 4 * 4 + 4
                else:
                    cand = torch.where(below, idx, F).amin(1)
                    lo, hi = off // 4 * 4, torch.full_like(off, F)
                b_act = torch.where(act, blk, -1)
                old += int(sectors(t, b_act, 0, F))
                new += int(sectors(t, b_act, lo, hi))
                ok = act & ((cand >= 0) if left else (cand < F))
                level = torch.where(ok, t, level)
                hit = torch.where(ok, blk * F + cand, hit)
                pos = torch.where(act, blk - 1 if left else blk + 1, pos)
            for t in range(int(level.max()), 0, -1):
                down = level >= t
                blk = torch.where(down, hit, -1)
                both = int(sectors(t - 1, blk, 0, F))
                old += both
                new += both
                below = block(t - 1, blk) < v[:, None]
                cand = (torch.where(below, idx, -1).amax(1) if left else
                        torch.where(below, idx, F).amin(1))
                hit = torch.where(down, hit * F + cand, hit)
    return old, new


def _scan_sectors(rank, trace, pyr, layout: str, m: int) -> dict:
    """Sectors the scan kernel touches on one chunk, counted from the
    plain loop's ``trace`` (``scan_mode.ScanTrace``), for the whole-row
    design (16 a rank row, whole pyramid blocks) and this one (the
    nearer-counter chunks, the ascent's side of each block): rank rows (2
    an attempt that reads them), pyramid blocks, LCP values (2 a
    shortening) and the query and output streams (9 B a position); and
    the symbol words the nearer-counter counts need (``_row_words``)."""
    import torch

    per_row = rank.SCAN_LAYOUTS[layout]
    per_chunk = per_row // (rank.ROW_WORDS // 4 - 1)
    j = torch.cat([o.reshape(-1) for o in trace.occ]).to(torch.int64)
    exp = torch.cat(trace.expand, dim=1)
    rows_new = int(_row_sectors(j, per_row, per_chunk).sum())
    row_words = int(_row_words(j, per_row,
                               rank.ROW_WORDS - rank.CNT_WORDS).sum())
    blocks_old, blocks_new = _pyramid_sectors(pyr, exp)
    lcp = 2 * int(exp[3].sum())
    stream = -(-9 * m // 32)
    res = {"row_reads": j.numel(), "expansions": exp.shape[1],
           "rows_old": 16 * j.numel(), "rows_new": rows_new,
           "blocks_old": blocks_old, "blocks_new": blocks_new,
           "lcp": lcp, "stream": stream, "row_words": row_words}
    res["old"] = res["rows_old"] + blocks_old + lcp + stream
    res["new"] = rows_new + blocks_new + lcp + stream
    return res


def _scan_kernel_vs_plain(rank, scan_mode, index, qt, layout: str, L: int,
                          lane_block: int) -> dict:
    """Phase 2s for one table layout: the scan kernel against the plain
    lockstep loop (the layout's plain occ) on one query chunk ``qt``,
    exact; kernel time by CUDA events after a warm-up; the plain run's
    time, backward-extend attempts and expansions (its trace); the bound
    (bytes: tables, pyramid, query, 8 B out per position, each once; ops:
    the integer work on the symbol words each occ of the trace needs from
    its nearer counter), the first design's whole-row bound (ops: two
    whole rows an attempt) beside it, the sectors touched
    (``_scan_sectors``) at the memory rate, and a latency estimate
    (dependent round trips per warp slot)."""
    import torch

    rows = (rank.nibble_rows if layout == "nib" else
            rank.interleaved_rows)(index)
    pyr = scan_mode.get_pyramid(index)
    plain_occ = (rank.rank_rows_nib_plain if layout == "nib" else
                 rank.rank_rows_plain)

    def kernel():
        return rank.scan_lanes(rows, layout, index.counts, pyr, qt, L,
                               lane_block)

    got = kernel()
    torch.cuda.synchronize()
    trace = scan_mode.ScanTrace()
    t0 = time.perf_counter()
    want = scan_mode._scan_lanes(index, pyr, lambda c, p: plain_occ(
        rows, c, p), qt, L, lane_block, trace)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"scan_lanes {layout}: kernel != plain loop "
                             f"(max abs err {err})")
    ms = _cuda_ms(kernel, 10)
    m = qt.numel()
    S = lane_block + L
    lanes = -(-m // lane_block)
    live_steps = sum(min(S, m - g * lane_block) for g in range(lanes))
    total = sum(trace.attempts)
    sectors = _scan_sectors(rank, trace, pyr, layout, m)
    del trace
    # each attempt and each expansion >= one dependent L2 trip
    round_trips = total + sectors["expansions"]
    props = torch.cuda.get_device_properties(0)
    per_sm = rank.load_kernel().blocks_per_sm(0 if layout == "k0" else 1)
    slots = min(lanes, props.multi_processor_count * per_sm * 8)
    per_slot = round_trips / slots
    bound_bytes = (rows.numel() * 4 + sum(lv.numel() * 4 for lv in pyr.levels)
                   + m + 16 + 8 * m)
    # per symbol word: nib 8 ops, K0 16 (as _kernel_vs_plain)
    per_word = 8 if layout == "nib" else 16
    bound_ops = sectors["row_words"] * per_word
    whole_row_ops = total * 2 * (rank.ROW_WORDS - rank.CNT_WORDS) * per_word
    bytes_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = bound_ops / SCALAR_OPS_PER_S * 1e3
    whole_row_ms = max(bytes_ms, whole_row_ops / SCALAR_OPS_PER_S * 1e3)
    sector_ms = {k: sectors[k] * 32 / HBM_BYTES_PER_S * 1e3
                 for k in ("old", "new")}
    res = {"positions": m, "lanes": lanes, "live_steps": live_steps,
           "attempts": total, "sectors": sectors,
           "sector_bound_ms": sector_ms["new"],
           "whole_row_sector_bound_ms": sector_ms["old"],
           "round_trips": round_trips, "blocks_per_sm": per_sm,
           "warp_slots": slots, "round_trips_per_slot": per_slot,
           "us_per_round_trip": ms * 1e3 / per_slot,
           "latency_est_ms": per_slot * ROUND_TRIP_US / 1e3,
           "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "whole_row_bound_ms": whole_row_ms}
    _log(f"[scan 2s] scan_lanes {layout}: {m} positions, {lanes} lanes, "
         f"{live_steps} live steps, {total} attempts, "
         f"{sectors['expansions']} expansions; kernel {ms:.6f} ms, plain "
         f"loop {plain_ms:.3f} ms (with the trace); bound "
         f"{res['bound_ms']:.6f} ms (bytes {bound_bytes}: {bytes_ms:.6f} ms,"
         f" ops {bound_ops} on {sectors['row_words']} nearer-side words: "
         f"{ops_ms:.6f} ms); whole-row bound {whole_row_ms:.6f} ms (ops "
         f"{whole_row_ops}); sectors touched "
         f"{sectors['new']} (rank rows {sectors['rows_new']}, pyramid blocks "
         f"{sectors['blocks_new']}, LCP {sectors['lcp']}, query and output "
         f"{sectors['stream']}): sector bound {sector_ms['new']:.6f} ms; "
         f"whole rows and blocks {sectors['old']} (rows "
         f"{sectors['rows_old']}, blocks {sectors['blocks_old']}): "
         f"{sector_ms['old']:.6f} ms; "
         f"{per_sm} blocks/SM, "
         f"{slots} warp slots, {per_slot:.1f} dependent round trips per "
         f"slot ({round_trips} in all): {res['us_per_round_trip']:.3f} us "
         f"each as measured, latency estimate {res['latency_est_ms']:.6f} ms"
         f" at {ROUND_TRIP_US} us; exact")
    return res


def _scan_frontend_split(rank, scan_mode, seed_mode, index, qry,
                         L: int) -> dict:
    """Phase 3c's scan frontend in parts, cold on a fresh index as in a
    CLI call (host clock, each part ending in a synchronise): the LCP
    array (``lcp_adjacent``, with its long pairs and launches), its
    pyramid (``LcpPyramid.build``), the nibble table, and the scan
    launches over the query's chunks (also by CUDA events)."""
    import torch

    from slamem_tpu_torch.index.lcp import lcp_adjacent
    from slamem_tpu_torch.kernels.lcp_search import LcpPyramid

    qt = seed_mode.query_to_device(qry, "cuda")[1]
    chunk = scan_mode._SCAN_CHUNK
    res = {}
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lcp = lcp_adjacent(index.text, index.sa, stats)
    torch.cuda.synchronize()
    res["lcp_adjacent_s"] = time.perf_counter() - t0
    res["long_pairs"], res["lcp_launches"] = (stats["long_pairs"],
                                              stats["launches"])
    t0 = time.perf_counter()
    index.derived["lcp_pyramid"] = LcpPyramid.build(lcp)
    torch.cuda.synchronize()
    res["pyramid_build_s"] = time.perf_counter() - t0
    del lcp
    t0 = time.perf_counter()
    rank.nibble_rows(index)
    torch.cuda.synchronize()
    res["nibble_table_s"] = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    before = rank.scan_lanes.launches["nib"]
    t0 = time.perf_counter()
    start.record()
    for a in range(0, qt.numel(), chunk):
        scan_mode.scan_intervals(index, qt[a:a + chunk + L], L)
    end.record()
    torch.cuda.synchronize()
    res["scan_s"] = time.perf_counter() - t0
    res["scan_event_ms"] = start.elapsed_time(end)
    res["scan_launches"] = rank.scan_lanes.launches["nib"] - before
    _log(f"[scan 3c] frontend split (cold, fresh index): lcp_adjacent "
         f"{res['lcp_adjacent_s']:.6f} s ({res['long_pairs']} long pairs, "
         f"{res['lcp_launches']} launches), LcpPyramid.build "
         f"{res['pyramid_build_s']:.6f} s, nibble table "
         f"{res['nibble_table_s']:.6f} s, {res['scan_launches']} scan "
         f"launches {res['scan_s']:.6f} s ({res['scan_event_ms']:.6f} ms by "
         f"CUDA events)")
    return res


def _wire_phase(pack2, label: str, codes, m_real: int) -> dict:
    """Phase u at one size: the packed upload wire (``codes_to_device``)
    against the host codes, byte for byte (positions >= m_real are N), the
    C pass's specials against ``np.flatnonzero``, and the unpack kernel
    against its plain version on the card on the same wire buffers; then
    times: the whole wire on the host clock (first call, whose pinned
    blocks are new, and the best of 3 later calls), its host half
    (pack_wire: the C pass that packs into pinned memory and finds the
    specials, the side channel; the C pack alone; beside them the JAX
    package's numpy scan for the specials), the pinned copies and the
    kernel (CUDA events), the plain unpack, and the plain uploads of the
    codes: a pageable copy (``torch.from_numpy(codes).to``) and a pinned
    copy (staging and transfer apart). Bound: (n/4 + 5 s + n) bytes at
    the memory rate."""
    import numpy as np
    import torch

    from slamem_tpu_torch.kernels.unpack2 import load_kernel

    dev = torch.device("cuda", 0)
    n, nb = codes.size, codes.size // 4
    want = torch.from_numpy(codes).clone()
    want[m_real:] = 4

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    wire_first, got = host_s(lambda: pack2.codes_to_device(codes, m_real,
                                                           dev))
    if got is None or not torch.equal(got.cpu(), want):
        raise AssertionError(f"u {label}: the wire's codes != the host codes")
    del got
    wire_s = min(host_s(lambda: pack2.codes_to_device(codes, m_real, dev))[0]
                 for _ in range(3))
    scan_s, spec = host_s(lambda: np.flatnonzero(codes[:m_real] >= 4))
    pack_wire_s, (plane_h, side_h) = host_s(
        lambda: pack2.pack_wire(codes, m_real, True))
    c_pack_s, _ = host_s(lambda: pack2.pack_codes_2bit(codes,
                                                       plane_h.numpy()))
    pb = torch.empty_like(plane_h, device=dev)
    side = torch.empty_like(side_h, device=dev)

    def copy():
        pb.copy_(plane_h, non_blocking=True)
        side.copy_(side_h, non_blocking=True)

    copy_ms = _cuda_ms(copy, 10)
    idx, val = pack2.split_side(side)
    s = idx.numel()
    if not np.array_equal(idx.cpu().numpy(), spec):
        raise AssertionError(f"u {label}: the C pass's {s} specials != "
                             f"np.flatnonzero's {spec.size}")
    got = pack2.unpack_codes(pb, idx, val, m_real)
    plain = pack2.unpack_codes_plain(pb, idx, val, m_real)
    torch.cuda.synchronize()
    err = int((got.to(torch.int16) - plain.to(torch.int16)).abs().max())
    if err or not torch.equal(got, plain) or not torch.equal(got.cpu(),
                                                             want):
        raise AssertionError(f"u {label}: kernel != plain (max abs err "
                             f"{err}) or != the host codes")
    fn = load_kernel().fn
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        if fn(pb.data_ptr(), nb, idx.data_ptr(), val.data_ptr(), s, m_real,
              got.data_ptr(), stream):
            raise RuntimeError("unpack kernel launch failed")

    ms = _cuda_ms(raw, 20)
    wrapper_ms = _cuda_ms(lambda: pack2.unpack_codes(pb, idx, val, m_real),
                          20)
    plain_ms = _cuda_ms(lambda: pack2.unpack_codes_plain(pb, idx, val,
                                                         m_real), 3)
    del got, plain, pb, side, idx, val
    pageable_first, dcodes = host_s(lambda: torch.from_numpy(codes).to(dev))
    pageable_s = min(host_s(lambda: torch.from_numpy(codes).to(dev))[0]
                     for _ in range(3))
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    stage_s, _ = host_s(lambda: np.copyto(pinned.numpy(), codes))
    pinned_copy_ms = _cuda_ms(lambda: dcodes.copy_(pinned, non_blocking=True),
                              10)
    del dcodes, pinned, plane_h, side_h
    bound_bytes = nb + 5 * s + n
    res = {"codes": n, "m_real": m_real, "specials": s,
           "wire_first_s": wire_first, "wire_s": wire_s,
           "numpy_spec_scan_s": scan_s, "c_pack_s": c_pack_s,
           "pack_wire_s": pack_wire_s, "copy_ms": copy_ms,
           "copy_gb_per_s": (nb + 5 * s) / (copy_ms * 1e-3) / 1e9,
           "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "pageable_first_s": pageable_first, "pageable_s": pageable_s,
           "pinned_stage_s": stage_s, "pinned_copy_ms": pinned_copy_ms,
           "max_abs_err": err, "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    _log(f"[wire u] {label}: {n} codes, m_real {m_real}, {s} specials; "
         f"wire {wire_s:.6f} s (first call {wire_first:.6f} s) = host "
         f"pack_wire {pack_wire_s:.6f} s (C pack alone {c_pack_s:.6f} s; "
         f"numpy's scan for the specials {scan_s:.6f} s) + pinned copy "
         f"{copy_ms:.6f} ms ({res['copy_gb_per_s']:.2f} GB/s) + kernel "
         f"{ms:.6f} ms (wrapper {wrapper_ms:.6f} ms, plain unpack "
         f"{plain_ms:.6f} ms, bound {res['bound_ms']:.6f} ms); plain "
         f"uploads of the codes: pageable {pageable_s:.6f} s (first "
         f"{pageable_first:.6f} s), pinned copy {pinned_copy_ms:.6f} ms + "
         f"staging {stage_s:.6f} s; kernel == plain == host codes")
    return res


def _wire_edges(pack2, seed_mode) -> None:
    """Phase u's edge cases on the card, each against the host codes:
    specials at position 0 and m_real - 1, a ragged last plane word (nb %
    4 != 0) with a special and the tail in it, no specials, exactly the
    1/8 gate (the wire), one past it and a half-N query (the plain route:
    ``codes_to_device`` is None, ``query_to_device`` copies, no launch)."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(HEADLINE["seed"])
    m = 40_003
    base = rng.integers(0, 4, m).astype(np.uint8)
    cases = {}
    q = base.copy()
    q[[0, m - 1]] = [5, 4]
    cases["first_last"] = q
    cases["none"] = base
    for name, k in (("gate", m // 8), ("gate_plus_one", m // 8 + 1)):
        q = base.copy()
        q[rng.choice(m, k, replace=False)] = 4
        cases[name] = q
    q = base.copy()
    q[: m // 2] = 4
    cases["half_n"] = q
    for name, q in cases.items():
        plain_route = name in ("gate_plus_one", "half_n")
        before = pack2.unpack_codes.launches
        qp, qt = seed_mode.query_to_device(q, dev)
        direct = pack2.codes_to_device(qp, m, dev)
        torch.cuda.synchronize()
        if (direct is None) != plain_route or not np.array_equal(
                qt.cpu().numpy(), qp) or pack2.unpack_codes.launches != \
                before + 2 * (not plain_route):
            raise AssertionError(f"u edge {name}: wrong route or codes")
    nb = 4097                              # ragged: 4097 % 4 == 1
    codes = rng.integers(0, 4, 4 * nb).astype(np.uint8)
    codes[4 * nb - 4] = 5                  # in the ragged last word
    m_real = 4 * nb - 3
    want = codes.copy()
    want[m_real:] = 4
    got = pack2.codes_to_device(codes, m_real, dev)
    if got is None or not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("u edge ragged: codes differ")
    # plane lengths at the dense pass's word, warp and block edges, with
    # no special, one, the edge ones and one in eight positions
    for nb in UNPACK_NB:
        n = 4 * nb
        m_real = max(n - 7, 0)
        for side, idx in (("none", []), ("one", rng.integers(0, n, 1)),
                          ("edges", [0, max(m_real - 1, 0), n - 1]),
                          ("eighth", rng.integers(0, n, max(n // 8, 1)))):
            idx = torch.from_numpy(np.unique(idx).astype(np.int32)).to(dev)
            pb = torch.from_numpy(rng.integers(0, 256, nb, dtype=np.uint8))
            pb = pb.to(dev)
            val = torch.randint(4, 6, idx.shape, dtype=torch.uint8,
                                device=dev)
            before = pack2.unpack_codes.launches
            got = pack2.unpack_codes(pb, idx, val, m_real)
            torch.cuda.synchronize()
            if pack2.unpack_codes.launches != before + 1 or not torch.equal(
                    got, pack2.unpack_codes_plain(pb, idx, val, m_real)):
                raise AssertionError(f"u nb {nb} {side}: kernel != plain "
                                     "or not one launch")
    _log(f"[wire u] edges: {', '.join(cases)}, ragged last word: codes == "
         "host codes; the gate + 1 and half-N queries took the plain copy "
         f"(no launch); nb {UNPACK_NB} x (no special, one, the edges, one "
         "in eight): kernel == plain, one launch each")


def _phase_u(pack2, seed_mode) -> dict:
    """Phase u: the wire at config #5's reference size (with an N run and
    separators) and at its query's (a 50 Mbp query cut into 10 entries,
    5d's shape, padded to its bucket as the upload pads it), then the
    edge cases. Returns each size's numbers."""
    import numpy as np

    rng = np.random.default_rng(CHR1["seed"])
    ref_codes = rng.integers(0, 4, CHR1["n"], dtype=np.uint8)
    ref_codes[WIRE_N_RUN] = 4
    ref_codes[::CHR1["n"] // 8] = 5
    qry_codes = rng.integers(0, 4, CHR1_QUERY_BP, dtype=np.uint8)
    qry_codes[CHR1_QUERY_BP // STRAINS::CHR1_QUERY_BP // STRAINS] = 5
    qry_codes[rng.integers(0, CHR1_QUERY_BP, 1000)] = 4
    wire = {"ref": _wire_phase(pack2, "6a reference", ref_codes, CHR1["n"]),
            "query": _wire_phase(pack2, "6a / 5d query",
                                 seed_mode.pad_query(qry_codes),
                                 CHR1_QUERY_BP)}
    del ref_codes, qry_codes
    _wire_edges(pack2, seed_mode)
    _log("[wire] " + json.dumps(wire, sort_keys=True))
    return wire


def _busy_share(fn) -> dict:
    """Run fn() once under torch.profiler: wall seconds of the window
    (ended by a synchronise) and the share of it during which a kernel ran
    on the card (union of the device events' intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:          # union of intervals, microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_s": wall, "device_events": len(spans),
            "busy_s": busy * 1e-6,
            "busy_share": busy * 1e-6 / wall if spans else None}


def _reset_launches(rank, pack2) -> None:
    """Every kernel wrapper's launch count to 0."""
    rank.rank_rows.launches = rank.rank_rows_nib.launches = 0
    rank.rank_rows_nib.any_launches = 0
    rank.scan_lanes.launches = dict.fromkeys(rank.SCAN_LAYOUTS, 0)
    pack2.unpack_codes.launches = 0


def _scan_launches(rank, layout: str, want: int, label: str) -> int:
    """The scan kernel's launches on ``layout`` since the last reset; raises
    unless they are ``want`` (one per chunk) and no other kernel (the other
    layout, a standalone rank kernel) was launched."""
    got = dict(rank.scan_lanes.launches)
    standalone = (rank.rank_rows.launches, rank.rank_rows_nib.launches,
                  rank.rank_rows_nib.any_launches)
    other = sum(standalone) + sum(v for k, v in got.items() if k != layout)
    if got[layout] != want or other:
        raise AssertionError(f"{label}: scan kernel launches {got}, "
                             f"standalone rank kernel launches "
                             f"{standalone}; expected "
                             f"{want} on the {layout} table alone")
    return got[layout]


class _ExtendTap:
    """Watches the seed engine's device tail on the card. It stands in for
    ``seed_mode.extend_runs`` and ``seed_mode.ext_arrays`` and calls them:
    the first keeps the inputs of its last call (phase e replays the
    merged, span-filtered runs of 5d and 6a), the second counts its calls
    on card tensors (the engine must build no extension table there). The
    kernel's wrapper counts its launches on the module's ``extend_runs``,
    which is the stand-in ``self.extend`` from here on."""

    def __init__(self, seed_mode) -> None:
        kernel, self.arrays = seed_mode.extend_runs, seed_mode.ext_arrays
        self.last = None
        self.builds = 0

        def extend_runs(*args):
            self.last = args
            return kernel(*args)

        def ext_arrays(text):
            self.builds += int(text.is_cuda)
            return self.arrays(text)

        extend_runs.launches = 0
        self.extend = seed_mode.extend_runs = extend_runs
        seed_mode.ext_arrays = ext_arrays

    def reset(self) -> None:
        """Counts to 0; forgets the last call's inputs."""
        self.extend.launches = 0
        self.builds = 0
        self.last = None

    def check(self, label: str) -> int:
        """The launches since the last reset; raises unless there was one
        and no extension table was built on the card."""
        if self.extend.launches != 1 or self.builds:
            raise AssertionError(
                f"{label}: {self.extend.launches} extension kernel launches "
                f"(expected 1), {self.builds} extension tables built on the "
                "card (expected 0)")
        return self.extend.launches

    def take(self) -> tuple:
        """The last call's inputs, tensors copied to the host; forgets
        them."""
        import torch

        args, self.last = self.last, None
        return tuple(a.cpu() if torch.is_tensor(a) else a for a in args)


def _edge_triples(ref, qry, stride: int, k: int, seed: int):
    """int64 numpy (diag, qs_s, qe_s) that put run boundaries at both text
    edges and beyond them (where extend_runs clamps), beside the texts'
    specials, and at random."""
    import numpy as np

    n, m = ref.size, qry.size
    m_s = -(-m // stride)
    rng = np.random.default_rng(seed)
    edge_q = np.array([-2, -1, 0, 1, m_s - 2, m_s - 1, m_s, m_s + 1])
    diag = [np.concatenate([[-m - 5, -e * stride, -e * stride - 1,
                             n - e * stride - k, n - e * stride, n - 3, n,
                             n + 20] for e in edge_q])]
    qs = [np.repeat(edge_q, 8)]
    spec_r = np.flatnonzero(ref >= 4)[:10_000]
    spec_q = np.flatnonzero(qry >= 4)[:10_000]
    q_r = rng.integers(0, m_s, spec_r.size)
    diag += [spec_r - q_r * stride + rng.integers(-3, 4, spec_r.size),
             rng.integers(-m, n, spec_q.size), rng.integers(-m, n, 100_000)]
    qs += [q_r, spec_q // stride, rng.integers(-1, m_s + 2, 100_000)]
    diag, qs = np.concatenate(diag), np.concatenate(qs)
    return diag, qs, qs + rng.integers(0, 4, qs.size)


def _window_triples(n: int, m: int, stride: int, k: int):
    """int64 numpy (diag, qs_s, qe_s) whose windows lie at every distance
    d = 0..33 from both ends of both texts: for each d, side and end, one
    triple puts that side's reference window and (exactly at stride 1, at
    the sample position at or below it otherwise) its query window d bytes
    from that end, and one more pairs the query's end with the
    reference's other end (tests/test_torch_cuda.py's triples)."""
    import numpy as np

    d = np.arange(34)
    q_l = np.concatenate([d + 16, m - d])
    r_l = np.concatenate([d + 16, n - d])
    q_r = np.concatenate([d, m - 16 - d])
    r_r = np.concatenate([d, n - 16 - d])
    qs_l = q_l // stride
    qe_r = (q_r - k) // stride
    diag = np.concatenate([r_l - qs_l * stride, r_l[::-1] - qs_l * stride,
                           r_r - (qe_r * stride + k),
                           r_r[::-1] - (qe_r * stride + k)])
    qs = np.concatenate([qs_l, qs_l, qe_r - 1, qe_r - 1])
    qe = np.concatenate([qs_l + 1, qs_l + 1, qe_r, qe_r])
    return diag, qs, qe


def _window_sectors(t, start, length: int = 16):
    """32-byte sectors of device memory under each window [start, start +
    length) of text t, clipped to the text (0 for a window outside it)."""
    import torch

    a, b = start.clamp(0, t.numel()), (start + length).clamp(0, t.numel())
    first = (t.data_ptr() + a) // 32
    last = (t.data_ptr() + b - 1) // 32
    return torch.where(b > a, last - first + 1, 0)


def _extend_phase(seed_mode, tap, label: str, args) -> dict:
    """Phase e at one input: the extension kernel (extend_runs) against its
    plain version (_extend_core over ext_arrays of both texts) on the card,
    exact, on the merged, span-filtered runs one engine call extended
    (``args``, the tap's record), on edge triples over the same texts
    (_edge_triples) and on window triples (_window_triples, at the run's
    stride and at stride 1), these three with both texts copied into views
    at byte offsets 0..15 of larger buffers (one launch each); then, on
    the engine's runs, times by CUDA events: the raw launch, the wrapper,
    the plain version as defined (both tables built) and its core alone
    (tables built beforehand, as the engine had them cached for the
    reference). Bound from this input: bytes = 40 per
    run (three int64 in, two out) + the text characters each result
    depends on (from each boundary out to the first mismatch or special,
    at most 16, inside the text, in both texts); operations = one compare
    per character pair + 10 per run. Sector bound: 40 B per run + the
    32-byte sectors under its four windows, at the memory rate."""
    import torch

    from slamem_tpu_torch.kernels.extend import load_kernel

    dev = torch.device("cuda", 0)
    diag, qs_s, qe_s, ref, qry, stride, k = (
        a.to(dev) if torch.is_tensor(a) else a for a in args[:7])
    n, m = ref.numel(), qry.numel()
    edges = [torch.from_numpy(x).to(dev) for x in _edge_triples(
        args[3].numpy(), args[4].numpy(), stride, k, 20260816)]
    windows = [torch.from_numpy(x).to(dev)
               for x in _window_triples(n, m, stride, k)]
    windows_1 = [torch.from_numpy(x).to(dev)
                 for x in _window_triples(n, m, 1, k)]
    ext_r, ext_q = tap.arrays(ref), tap.arrays(qry)

    def plain(d, a, b):
        return seed_mode._extend_core(d, a, b, tap.arrays(ref),
                                      tap.arrays(qry), stride, k)

    err = 0
    cases = (("engine runs", (diag, qs_s, qe_s), stride),
             ("edge triples", edges, stride),
             ("window triples", windows, stride),
             ("window triples, stride 1", windows_1, 1))
    wants = {}
    bufs = [torch.empty(t.numel() + 16, dtype=torch.uint8, device=dev)
            for t in (ref, qry)]
    for name, (d, a, b), s in cases:
        wants[name] = seed_mode._extend_core(d, a, b, ext_r, ext_q, s, k)
        # the engine's texts, else copies at byte offsets 0..15 of bufs
        offsets = [None] if name == "engine runs" else range(16)
        for r in offsets:
            rt, qt = ref, qry
            if r is not None:
                rt, qt = (buf[r:r + t.numel()].copy_(t)
                          for buf, t in zip(bufs, (ref, qry)))
            before = tap.extend.launches
            got = tap.extend(d, a, b, rt, qt, s, k)
            torch.cuda.synchronize()
            if tap.extend.launches != before + 1:
                raise AssertionError(f"e {label} {name}: no kernel launch")
            err = max(err, *(int((g - w).abs().max())
                             for g, w in zip(got, wants[name])))
            if err or not all(torch.equal(g, w)
                              for g, w in zip(got, wants[name])):
                raise AssertionError(f"e {label} {name} (texts at byte "
                                     f"offset {r}): kernel != plain (max "
                                     f"abs err {err})")
    qstart, qend = wants["engine runs"]
    del wants, bufs
    fn = load_kernel().fn
    out = (torch.empty_like(diag), torch.empty_like(diag))
    stream = torch.cuda.current_stream().cuda_stream
    nr = diag.numel()

    def raw():
        if fn(diag.data_ptr(), qs_s.data_ptr(), qe_s.data_ptr(), nr,
              ref.data_ptr(), n, qry.data_ptr(), m, stride, k,
              out[0].data_ptr(), out[1].data_ptr(), stream):
            raise RuntimeError("extension kernel launch failed")

    ms = _cuda_ms(raw, 50)
    wrapper_ms = _cuda_ms(lambda: tap.extend(diag, qs_s, qe_s, ref, qry,
                                             stride, k), 20)
    core_ms = _cuda_ms(lambda: seed_mode._extend_core(
        diag, qs_s, qe_s, ext_r, ext_q, stride, k), 10)
    del ext_r, ext_q
    plain_ms = _cuda_ms(lambda: plain(diag, qs_s, qe_s), 3)
    qs, qe_core = qs_s * stride, qe_s * stride
    qe_b = qe_core + k
    need_l = (qs - qstart + 1).clamp(max=16)
    need_r = (qend - qe_core + 1).clamp(max=16)
    chars = int(torch.minimum(need_l, qs.clamp(0, m)).sum()
                + torch.minimum(need_l, (qs + diag).clamp(0, n)).sum()
                + torch.minimum(need_r, m - qe_b.clamp(0, m)).sum()
                + torch.minimum(need_r, n - (qe_b + diag).clamp(0, n)).sum())
    bound_bytes = 40 * nr + chars
    bound_ops = chars // 2 + 10 * nr
    bytes_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = bound_ops / SCALAR_OPS_PER_S * 1e3
    rs, rb = (qs + diag).clamp(0, n), (qe_b + diag).clamp(0, n)
    qsc, qbc = qs.clamp(0, m), qe_b.clamp(0, m)
    sectors = int(sum(_window_sectors(t, start).sum() for t, start in (
        (qry, qsc - 16), (ref, rs - 16), (qry, qbc), (ref, rb))))
    sector_bytes = 40 * nr + 32 * sectors
    ext = (qs - qstart) + (qend - qe_core)
    res = {"runs": nr, "edge_triples": int(edges[0].numel()),
           "window_triples": int(windows[0].numel()), "view_offsets": 16,
           "stride": stride, "k": k, "ref_codes": n, "query_codes": m,
           "extended_runs": int((ext > 0).sum()),
           "max_ext": int(ext.max()) if nr else 0, "chars": chars,
           "sectors": sectors, "ms": ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "plain_core_ms": core_ms,
           "max_abs_err": err, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "sector_bound_ms": sector_bytes / HBM_BYTES_PER_S * 1e3}
    _log(f"[extend e] {label}: {nr} merged, span-filtered runs (K={k}, "
         f"stride {stride}; texts {n} + {m} codes) + "
         f"{res['edge_triples']} edge triples + {res['window_triples']} "
         f"window triples (at stride {stride} and 1; the edge and window "
         f"triples with the texts at byte offsets 0..15): kernel == "
         f"plain; kernel {ms:.6f} ms (wrapper {wrapper_ms:.6f} ms), plain "
         f"{plain_ms:.6f} ms (its core alone, tables built: {core_ms:.6f} "
         f"ms); bound {res['bound_ms']:.6f} ms (bytes {bound_bytes}: "
         f"{bytes_ms:.6f} ms, ops {bound_ops}: {ops_ms:.6f} ms); sector "
         f"bound {res['sector_bound_ms']:.6f} ms ({sectors} sectors + 40 B "
         f"a run: {sector_bytes} B); {res['extended_runs']} runs "
         f"extended, by at most {res['max_ext']}")
    return res


def _exact(label: str, got, want) -> int:
    """Max abs difference of equal-shaped tensor tuples; raises unless
    they are equal."""
    import torch

    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{label}: kernel != plain (max abs err {err})")
    return err


def _bound(bound_bytes: int, bound_ops: int) -> dict:
    bytes_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = bound_ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_bytes": bound_bytes, "bound_ops": bound_ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


OCC_N = CHR1["n"] + 1            # chr1's reference and its terminator
OCC_BLOCK = 128                  # Config.occ_block, the CLI's spacing


def _occ_plain_inner(bwt, block: int):
    """occ_checkpoints_plain with its cumsum along the contiguous dimension
    of the (4, n_blocks) transpose (the scan CUB runs in parallel), not the
    outer dimension of (n_blocks, 4): the fair library version of the
    checkpoints, a yardstick only."""
    import torch

    from slamem_tpu_torch.index.build import BWT_SENTINEL

    n = bwt.numel()
    n_blocks = -(-n // block)
    pad = torch.full((n_blocks * block - n,), BWT_SENTINEL,
                     dtype=torch.uint8, device=bwt.device)
    padded = torch.cat([bwt, pad]).view(n_blocks, block)
    per_block = torch.stack([(padded == c).sum(1, dtype=torch.int32)
                             for c in range(4)])
    scanned = torch.cumsum(per_block, 1, dtype=torch.int32).t()
    return torch.cat([torch.zeros((1, 4), dtype=torch.int32,
                                  device=bwt.device), scanned])


def _phase_o(index_build) -> dict:
    """Phase o: the occ checkpoint kernel (index_build.occ_checkpoints) on a
    BWT of chr1's 250,000,001 symbols (random codes with N, SEP and the
    sentinel among them) at occ_block 128 against occ_checkpoints_plain,
    exact, and the same 1 byte past a 16-byte boundary (the byte path);
    times by CUDA events of the raw launches, the wrapper, the plain
    version, the plain version with the cumsum along the contiguous
    dimension (``_occ_plain_inner``, exact too), and the library yardstick
    torch.cumsum over the (4, n_blocks) transpose of the block counts along
    its contiguous dimension (``library_ms``; ``outer_cumsum_ms``: along
    the outer dimension of (n_blocks, 4), the parent's call); the port
    calls neither. Bound: bytes, n read and 16 (n_blocks + 1) written.
    Whether a build launches it once is the CLI phases' check
    (``_table_launches``)."""
    import torch

    from slamem_tpu_torch.kernels.occ import load_kernel

    gen = torch.Generator(device="cuda").manual_seed(HEADLINE["seed"])
    whole = torch.randint(0, 4, (OCC_N + 16,), generator=gen, device="cuda",
                          dtype=torch.uint8)
    for code, count in ((4, 1 << 20), (5, 1 << 16), (6, 1)):
        whole[torch.randint(0, whole.numel(), (count,), generator=gen,
                            device="cuda")] = code
    bwt = whole[:OCC_N]
    got = index_build.occ_checkpoints(bwt, OCC_BLOCK)
    want = index_build.occ_checkpoints_plain(bwt, OCC_BLOCK)
    torch.cuda.synchronize()
    err = _exact("o occ checkpoints", (got,), (want,))
    shifted = whole[1:OCC_N + 1]
    err = max(err, _exact(
        "o occ checkpoints, 1 byte past 16-byte alignment",
        (index_build.occ_checkpoints(shifted, OCC_BLOCK),),
        (index_build.occ_checkpoints_plain(shifted, OCC_BLOCK),)))
    _exact("o plain checkpoints, cumsum along the contiguous dimension",
           (_occ_plain_inner(bwt, OCC_BLOCK),), (want,))
    n_blocks = want.shape[0] - 1
    per_block = want[1:] - want[:-1]
    per_block_t = per_block.t().contiguous()
    del want
    kernel = load_kernel()
    sums = torch.empty((kernel.tiles(OCC_N), 4), dtype=torch.int32,
                       device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def raw(b=bwt):
        if kernel.fn(b.data_ptr(), b.numel(), OCC_BLOCK, sums.data_ptr(),
                     got.data_ptr(), stream):
            raise RuntimeError("occ checkpoint kernel launch failed")

    ms = _cuda_ms(raw, 50)
    byte_ms = _cuda_ms(lambda: raw(shifted), 10)
    wrapper_ms = _cuda_ms(
        lambda: index_build.occ_checkpoints(bwt, OCC_BLOCK), 50)
    plain_ms = _cuda_ms(
        lambda: index_build.occ_checkpoints_plain(bwt, OCC_BLOCK), 3)
    plain_inner_ms = _cuda_ms(lambda: _occ_plain_inner(bwt, OCC_BLOCK), 10)
    library_ms = _cuda_ms(
        lambda: torch.cumsum(per_block_t, 1, dtype=torch.int32).t(), 10)
    outer_ms = _cuda_ms(
        lambda: torch.cumsum(per_block, 0, dtype=torch.int32), 3)
    res = {"n": OCC_N, "occ_block": OCC_BLOCK, "n_blocks": n_blocks,
           "ms": ms, "byte_path_ms": byte_ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "plain_inner_ms": plain_inner_ms,
           "library_ms": library_ms, "outer_cumsum_ms": outer_ms,
           "max_abs_err": err, **_bound(OCC_N + 16 * (n_blocks + 1), 0)}
    res["bound_share_pct"] = 100.0 * res["bound_ms"] / ms
    _log(f"[occ o] {OCC_N} symbols, occ_block {OCC_BLOCK} ({n_blocks} "
         f"blocks): kernel == plain (aligned and 1 byte past); kernel "
         f"{ms:.6f} ms ({res['bound_share_pct']:.1f}% of the bound "
         f"{res['bound_ms']:.6f} ms, {res['bound_by']}), byte path "
         f"{byte_ms:.6f} ms, wrapper {wrapper_ms:.6f} ms, plain "
         f"{plain_ms:.6f} ms, plain with the contiguous cumsum "
         f"{plain_inner_ms:.6f} ms; torch.cumsum of the block counts along "
         f"the contiguous dimension {library_ms:.6f} ms, along the outer "
         f"one {outer_ms:.6f} ms")
    del whole, bwt, shifted, got, per_block, per_block_t, sums
    torch.cuda.empty_cache()
    return res


# every chr1 run's peak when the suffix sort started from 1-character ranks
CHR1_PEAK_BYTES = 15_559_308_288


def _phase_k(index_build) -> dict:
    """Phase k: the suffix sort's window-key kernel (index_build.sa_keys) at
    chr1's 250,000,001 symbols against sa_keys_plain, exact: the chr1
    cells' kind of text (uniform codes, 20 N runs of 10,000, SEP last),
    aligned and 1 byte past a 16-byte boundary, and a stress text with a
    special at one position in 240 (2^20 N, 2^10 SEP, scattered), where
    windows that hold one are everywhere; times by CUDA events of the raw
    launch on each, the wrapper and the plain version. Bound: bytes, n
    read and 8 n written. Whether a build launches it once is the CLI
    phases' check (``_table_launches``)."""
    import torch

    from slamem_tpu_torch.kernels.sakeys import load_kernel

    gen = torch.Generator(device="cuda").manual_seed(HEADLINE["seed"] + 1)

    def codes():
        return torch.randint(0, 4, (OCC_N + 16,), generator=gen,
                             device="cuda", dtype=torch.uint8)

    whole = codes()
    for at in torch.randint(0, OCC_N - 10_000, (20,), generator=gen,
                            device="cuda").tolist():
        whole[at:at + 10_000] = 4
    whole[OCC_N - 1] = whole[OCC_N] = 5
    stress = codes()
    for code, count in ((4, 1 << 20), (5, 1 << 10)):
        stress[torch.randint(0, OCC_N, (count,), generator=gen,
                             device="cuda")] = code
    stress[OCC_N - 1] = 5
    text, shifted, stress = whole[:OCC_N], whole[1:OCC_N + 1], \
        stress[:OCC_N]
    err = 0
    for label, t in (("", text), (", 1 byte past 16-byte alignment",
                                  shifted), (", scattered specials", stress)):
        got = index_build.sa_keys(t)
        want = index_build.sa_keys_plain(t)
        torch.cuda.synchronize()
        err = max(err, _exact(f"k window keys{label}", (got,), (want,)))
        del want
    kernel = load_kernel()
    stream = torch.cuda.current_stream().cuda_stream

    def raw(t=text):
        if kernel.fn(t.data_ptr(), t.numel(), got.data_ptr(), stream):
            raise RuntimeError("window key kernel launch failed")

    ms = _cuda_ms(raw, 50)
    off_ms = _cuda_ms(lambda: raw(shifted), 20)
    stress_ms = _cuda_ms(lambda: raw(stress), 20)
    wrapper_ms = _cuda_ms(lambda: index_build.sa_keys(text), 20)
    plain_ms = _cuda_ms(lambda: index_build.sa_keys_plain(text), 3)
    res = {"n": OCC_N, "ms": ms, "offset_ms": off_ms,
           "scattered_ms": stress_ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "max_abs_err": err,
           **_bound(9 * OCC_N, 0)}
    res["bound_share_pct"] = 100.0 * res["bound_ms"] / ms
    _log(f"[keys k] {OCC_N} symbols: kernel == plain (aligned, 1 byte "
         f"past, scattered specials); kernel {ms:.6f} ms "
         f"({res['bound_share_pct']:.1f}% of the bound "
         f"{res['bound_ms']:.6f} ms, {res['bound_by']}), 1 byte off "
         f"{off_ms:.6f} ms, one special in 240 {stress_ms:.6f} ms, wrapper "
         f"{wrapper_ms:.6f} ms, plain {plain_ms:.6f} ms")
    del whole, text, shifted, stress, got
    torch.cuda.empty_cache()
    return res


def _seed_table_t(seed_mode, label: str, index, k: int) -> dict:
    """Phase t, the seed table of one index at one K: seed_table_rows'
    two kernels (the plane pass and the gather) against
    seed_table_rows_plain on the card, exact (refk and sa_aug); times by
    CUDA events of the raw launches (the pair, and each alone), the
    wrapper and the plain version (the old cold path: a key per text
    position, then two gathers). Counts: the invalid rows, the rows the
    gather sends to the exact path (a flag set on a word under the window,
    or the window past the text), the 32-byte sectors under each row's
    window in the uint8 text (what PR 10's one-launch design read) and in
    the plane (what the gather reads: a 16-byte pair of words a row, and
    the next word alone where the window reaches past the pair). Bound:
    bytes = 16 per row (sa in, refk and sa_aug out) + the text once;
    operations = 2 K per row; sector bound = 16 B a row + the text
    sectors; plane sector bound = 16 B a row + the plane sectors + the
    plane pass's bytes (the gather with no plane read served by L2)."""
    import torch

    from slamem_tpu_torch.kernels.seedkeys import load_kernel

    text, sa = index.text, index.sa
    rows, n = sa.numel(), text.numel()
    got = seed_mode.seed_table_rows(text, sa, k)
    want = seed_mode.seed_table_rows_plain(text, sa, k)
    torch.cuda.synchronize()
    err = _exact(f"t {label} seed table", got, want)
    del want
    refk, sa_aug = got
    kern = load_kernel()
    stream = torch.cuda.current_stream().cuda_stream
    words = -(-n // 31)
    plane = torch.empty(words + (words & 1), dtype=torch.int64,
                        device=text.device)

    def plane_pass():
        if kern.seed_plane(text.data_ptr(), n, plane.data_ptr(), stream):
            raise RuntimeError("seed plane kernel launch failed")

    def gather():
        if kern.seed_gather(text.data_ptr(), n, plane.data_ptr(),
                            sa.data_ptr(), rows, k, refk.data_ptr(),
                            sa_aug.data_ptr(), stream):
            raise RuntimeError("seed gather kernel launch failed")

    def raw():
        plane_pass()
        gather()

    big = rows > 10 ** 8
    ms = _cuda_ms(raw, 5 if big else 50)
    plane_ms = _cuda_ms(plane_pass, 5 if big else 50)
    gather_ms = _cuda_ms(gather, 5 if big else 50)
    wrapper_ms = _cuda_ms(lambda: seed_mode.seed_table_rows(text, sa, k),
                          5 if big else 20)
    plain_ms = _cuda_ms(lambda: seed_mode.seed_table_rows_plain(text, sa, k),
                        2 if big else 5)
    plane_pass()
    a = sa.to(torch.int64)
    sectors = int(_window_sectors(text, a, k).sum())
    # the gather's loads: the pair holding word w (its sector w // 4), and
    # word w + 1 alone when w is odd and the window reaches it
    inside = a + k <= n
    w = a // 31
    two = a - 31 * w + k > 31
    del a
    flag = (plane & 1).bool()
    exact = int((~inside | flag[w] | (two & flag[(w + 1).clamp(
        max=words - 1)])).sum())
    alone = inside & two & (w & 1).bool()
    plane_sectors = int(inside.sum()) + int(
        (alone & ((w + 1) >> 2 != w >> 2)).sum())
    del inside, w, two, flag, alone, plane
    pass_bytes = n + 8 * words
    res = {"rows": rows, "k": k, "invalid_rows": int((sa_aug < 0).sum()),
           "exact_rows": exact, "sectors": sectors,
           "plane_sectors": plane_sectors, "ms": ms, "plane_ms": plane_ms,
           "gather_ms": gather_ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "max_abs_err": err,
           **_bound(16 * rows + n, 2 * k * rows),
           "sector_bound_ms": (16 * rows + 32 * sectors) / HBM_BYTES_PER_S
           * 1e3,
           "plane_sector_bound_ms": (16 * rows + 32 * plane_sectors
                                     + pass_bytes) / HBM_BYTES_PER_S * 1e3}
    _log(f"[tables t] {label} seed table: {rows} rows, K={k} "
         f"({res['invalid_rows']} invalid, {exact} on the exact path): "
         f"kernels == plain; plane pass + gather {ms:.6f} ms (plane "
         f"{plane_ms:.6f} ms, gather {gather_ms:.6f} ms; wrapper "
         f"{wrapper_ms:.6f} ms), plain {plain_ms:.6f} ms; bound "
         f"{res['bound_ms']:.6f} ms ({res['bound_by']}: "
         f"{res['bound_bytes']} B, {res['bound_ops']} ops); text sector "
         f"bound {res['sector_bound_ms']:.6f} ms ({sectors} sectors, "
         f"{sectors / max(rows, 1):.3f} a row); plane sector bound "
         f"{res['plane_sector_bound_ms']:.6f} ms ({plane_sectors} sectors, "
         f"{plane_sectors / max(rows, 1):.3f} a row)")
    return res


def _bucket_t(seed_mode, label: str, k: int, bbits: int, shift: int,
              slabs) -> dict:
    """Phase t, one bucket table or a set of ranged slab tables (``slabs``:
    (rows, base, real) each): bucket_starts' kernel against
    bucket_starts_plain on the card, exact, and the largest bucket against
    the plain one's (histogram max); torch.searchsorted of the rows'
    prefixes over every bucket (the library call), == the starts; times by
    CUDA events of the raw launches, the wrappers, the plain versions and
    the library calls, over all the tables; for one direct or shifted
    table also the old cold path (_build_bucket_table over _key_word0, its
    host read included). The prefixes' gaps: the widest one a boundary
    thread meets (its warp's when it is more than 32 entries), those
    wider than 32, and the grid's (below the first row, above the last).
    The streaming yardstick: the same bytes through two PyTorch calls a
    table, a sum over the real rows' keys (8 B a row read) and a fill of
    the table (4 B an entry written). Bound: bytes = 8 per real row read +
    4 per entry written; operations = 4 per row + 1 per entry."""
    import torch

    from slamem_tpu_torch.kernels.buckets import load_kernel

    dev = slabs[0][0].device
    nb = 1 << bbits
    outs, prefs = [], []
    err = widest = wide = grid_gap = 0
    for rows, base, real in slabs:
        got = seed_mode.bucket_starts(rows, k, bbits, shift, base, real)
        want = seed_mode.bucket_starts_plain(rows, k, bbits, shift, base,
                                             real)
        torch.cuda.synchronize()
        err = max(err, _exact(f"t {label} bucket starts", (got,), (want,)))
        rc = max(0, min(rows.numel(), real))
        rel = seed_mode._key_word0(rows, k) - (base << shift)
        rel[rc:] = seed_mode._PAD_WORD0 - (base << shift)
        pref = (rel >> shift).clamp(max=nb - 1)
        largest = seed_mode._build_bucket_table(rel, bbits, shift)[1]
        if int((got[1:] - got[:-1]).max()) != largest:
            raise AssertionError(f"t {label}: largest bucket != plain's")
        del rel, want
        # entries a boundary thread writes: pref(i) - pref(i - 1)
        d = pref[1:rc] - pref[:max(rc - 1, 0)]
        widest = max(widest, int(d.max()) if d.numel() else 0)
        wide += int((d > 32).sum())
        grid = [int(pref[0]) + 1, nb - int(pref[-1])]
        if 0 < rc < rows.numel():           # the pads' gap
            grid.append(int(pref[rc]) - int(pref[rc - 1]))
        grid_gap = max(grid_gap, *grid)
        outs.append(got)
        prefs.append(pref)
    ar = torch.arange(nb + 1, dtype=torch.int64, device=dev)
    for got, pref in zip(outs, prefs):
        lib = torch.searchsorted(pref, ar, side="left")
        if not torch.equal(lib.to(torch.int32), got):
            raise AssertionError(f"t {label}: searchsorted != the starts")
    del lib
    fn = load_kernel().fn
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        for (rows, base, real), out in zip(slabs, outs):
            if fn(rows.data_ptr(), rows.numel(), real, k, base, shift, nb,
                  out.data_ptr(), stream):
                raise RuntimeError("bucket start kernel launch failed")

    def wrapper():
        for (rows, base, real), out in zip(slabs, outs):
            seed_mode.bucket_starts(rows, k, bbits, shift, base, real, out)

    def plain():
        for rows, base, real in slabs:
            seed_mode.bucket_starts_plain(rows, k, bbits, shift, base, real)

    def library():
        for pref in prefs:
            torch.searchsorted(pref, ar, side="left")

    def yardstick():
        for (rows, _, real), out in zip(slabs, outs):
            rows[:max(0, min(rows.numel(), real))].sum()
            out.fill_(0)

    big = nb * len(slabs) > 1 << 27
    ms = _cuda_ms(raw, 5 if big else 50)
    wrapper_ms = _cuda_ms(wrapper, 5 if big else 20)
    plain_ms = _cuda_ms(plain, 2 if big else 5)
    library_ms = _cuda_ms(library, 2 if big else 5)
    yard_ms = _cuda_ms(yardstick, 5 if big else 50)
    old_ms = None
    if len(slabs) == 1 and slabs[0][1] == 0:
        w0 = seed_mode._key_word0(slabs[0][0], k)
        old_ms = _cuda_ms(lambda: seed_mode._build_bucket_table(
            w0, bbits, shift), 2 if big else 5)
        del w0
    del ar, prefs
    real_rows = sum(min(rows.numel(), max(real, 0))
                    for rows, _, real in slabs)
    entries = len(slabs) * (nb + 1)
    res = {"tables": len(slabs), "rows": sum(r.numel() for r, _, _ in slabs),
           "real_rows": real_rows, "k": k, "bbits": bbits, "shift": shift,
           "largest_bucket": max(int((g[1:] - g[:-1]).max()) for g in outs),
           "widest_boundary_gap": widest, "gaps_over_32": wide,
           "widest_grid_gap": grid_gap, "ms": ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "old_ms": old_ms,
           "yardstick_ms": yard_ms, "max_abs_err": err,
           **_bound(8 * real_rows + 4 * entries, 4 * real_rows + entries)}
    _log(f"[tables t] {label} bucket starts: {len(slabs)} table(s) of "
         f"{nb + 1} entries over {res['rows']} rows ({real_rows} real), "
         f"K={k}, shift {shift}: kernel == plain == searchsorted, largest "
         f"bucket {res['largest_bucket']}; kernel {ms:.6f} ms (wrapper "
         f"{wrapper_ms:.6f} ms), plain {plain_ms:.6f} ms, searchsorted "
         f"{library_ms:.6f} ms, old path "
         f"{'-' if old_ms is None else f'{old_ms:.6f} ms'}; bound "
         f"{res['bound_ms']:.6f} ms ({res['bound_by']}), yardstick (sum + "
         f"fill) {yard_ms:.6f} ms; widest gap: a "
         f"boundary's {widest} entries ({wide} over 32, the warp's), the "
         f"grid's {grid_gap}")
    del outs
    return res


def _pack_t(seed_mode, label: str, qt, k: int, stride: int) -> dict:
    """Phase t, the query's key pack: packed_key_words' kernel against
    packed_key_words_plain on the card, exact (keys and valid); times by
    CUDA events of the raw launch, the wrapper and the plain version.
    Bound: bytes = the text once + 9 per window (key and flag out);
    operations = 2 K per window."""
    import torch

    from slamem_tpu_torch.kernels.seedkeys import load_kernel

    n = qt.numel()
    got = seed_mode.packed_key_words(qt, k, stride)
    want = seed_mode.packed_key_words_plain(qt, k, stride)
    torch.cuda.synchronize()
    err = _exact(f"t {label} key pack", got, want)
    keys, valid = got
    ns = keys.numel()
    fn = load_kernel().pack_keys
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        if fn(qt.data_ptr(), n, stride, k, keys.data_ptr(), valid.data_ptr(),
              stream):
            raise RuntimeError("key pack kernel launch failed")

    ms = _cuda_ms(raw, 50)
    wrapper_ms = _cuda_ms(lambda: seed_mode.packed_key_words(qt, k, stride),
                          20)
    plain_ms = _cuda_ms(lambda: seed_mode.packed_key_words_plain(
        qt, k, stride), 5)
    res = {"codes": n, "windows": ns, "k": k, "stride": stride,
           "valid": int(valid.sum()), "ms": ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "max_abs_err": err,
           **_bound(n + 9 * ns, 2 * k * ns)}
    _log(f"[tables t] {label} key pack: {ns} windows of {n} codes, K={k}, "
         f"stride {stride}: kernel == plain; kernel {ms:.6f} ms (wrapper "
         f"{wrapper_ms:.6f} ms), plain {plain_ms:.6f} ms; bound "
         f"{res['bound_ms']:.6f} ms ({res['bound_by']})")
    return res


def _direct_bucket_plan(index, k: int) -> tuple[int, int]:
    """(bbits, shift) of seed_mode.bucket_table at this index and K."""
    word0_bits = 2 * min(k, 16)
    if word0_bits <= 28 and (1 << word0_bits) <= max(64 * index.n, 1 << 22):
        return word0_bits, 0
    bbits = min(word0_bits, 24)
    return bbits, word0_bits - bbits


def _listing_matches(path: str) -> list[tuple[int, int, int]]:
    out = []
    with open(path) as f:
        for line in f:
            if not line.startswith(">"):
                r, q, ln = line.split()[-3:]
                out.append((int(r), int(q), int(ln)))
    return out


def _check_maximal(ref, qry, matches) -> None:
    """Every listed (1-based) match is exact and extends in neither
    direction (single-sequence reference and query)."""
    import numpy as np

    n, m = len(ref), len(qry)
    for r, q, ln in matches:
        r0, q0 = r - 1, q - 1
        if r0 < 0 or q0 < 0 or r0 + ln > n or q0 + ln > m:
            raise AssertionError(f"match ({r}, {q}, {ln}) out of range")
        if not np.array_equal(ref[r0:r0 + ln], qry[q0:q0 + ln]):
            raise AssertionError(f"match ({r}, {q}, {ln}) is not exact")
        if r0 > 0 and q0 > 0 and ref[r0 - 1] == qry[q0 - 1] < 4:
            raise AssertionError(f"match ({r}, {q}, {ln}) extends left")
        if (r0 + ln < n and q0 + ln < m
                and ref[r0 + ln] == qry[q0 + ln] < 4):
            raise AssertionError(f"match ({r}, {q}, {ln}) extends right")


def _cli(main, argv: list[str]) -> str:
    """Run the port's CLI; returns its stderr. Raises on a non-zero exit."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv} exited {rc}: {err.getvalue()}")
    return err.getvalue()


def _verbose_stats(stderr: str) -> dict:
    """The CLI's ``-v`` lines: index build s, query s, Mbp/s, and the plan
    and stage seconds of its (one) engine call."""
    head = re.search(r"index build: ([0-9.]+)s; query: ([0-9.]+) Mbp in "
                     r"([0-9.]+)s \(([0-9.]+) Mbp/s\)", stderr)
    search = re.search(r"search: (.*); stage s: (.*)", stderr)
    if head is None or search is None:
        raise AssertionError(f"no statistics lines in {stderr!r}")
    return {"build_s": float(head.group(1)), "query_s": float(head.group(3)),
            "mbp_per_s": float(head.group(4)),
            "plan": dict(re.findall(r"(\w+)=(\S+)", search.group(1))),
            "stage_s": {k: float(v) for k, v in
                        re.findall(r"(\w+)=([0-9.]+)", search.group(2))}}


def _table_launches(seed_mode) -> dict:
    """The table kernels' launches since the last reset (and resets them):
    the seed table, the bucket starts, the query's key pack and the index
    build's occ checkpoints and window keys."""
    from slamem_tpu_torch.index import build as index_build

    got = {"seed_table": seed_mode.seed_table_rows.launches,
           "bucket_starts": seed_mode.bucket_starts.launches,
           "packed_key_words": seed_mode.packed_key_words.launches,
           "occ_checkpoints": index_build.occ_checkpoints.launches,
           "sa_keys": index_build.sa_keys.launches}
    seed_mode.seed_table_rows.launches = 0
    seed_mode.bucket_starts.launches = 0
    seed_mode.packed_key_words.launches = 0
    index_build.occ_checkpoints.launches = 0
    index_build.sa_keys.launches = 0
    return got


def _seed_phase(cli_main, tap, label: str, flags: list[str], want: int,
                rp: str, qp: str, out: str, buckets: int = 1) -> dict:
    """One default-engine CLI run on the card: count, plan, stage times,
    peak device memory, the suffix sort's sorts. Raises if the count is
    not ``want``, unless the call launched the extension kernel once and
    built no extension table on the card (``tap``), or unless it launched
    the seed-table kernel once and the occ checkpoint and window-key
    kernels once each (the CLI builds its index cold), the bucket-start
    kernel ``buckets`` times (a table, one a slab, none for the join
    frontend) and the key pack once (one engine call)."""
    import torch

    from slamem_tpu_torch.engine import seed_mode
    from slamem_tpu_torch.index import build as index_build

    tap.reset()
    _table_launches(seed_mode)
    sorts = index_build.suffix_array.sorts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stderr = _cli(cli_main, [*flags, "-device", "cuda", "-v", "-o", out, rp,
                             qp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = _verbose_stats(stderr)
    st["extend_launches"] = tap.check(label)
    st["table_launches"] = _table_launches(seed_mode)
    st["sa_sorts"] = index_build.suffix_array.sorts - sorts
    if st["table_launches"] != {"seed_table": 1, "bucket_starts": buckets,
                                "packed_key_words": 1, "occ_checkpoints": 1,
                                "sa_keys": 1}:
        raise AssertionError(f"{label}: table kernel launches "
                             f"{st['table_launches']}, expected 1, "
                             f"{buckets}, 1, 1, 1")
    st["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    st["matches"] = len(_listing_matches(out))
    st["wall_s"] = wall
    # what the engine's stages leave of the query: mode filter, emission
    st["host_tail_s"] = st["query_s"] - sum(st["stage_s"].values())
    plan = " ".join(f"{k}={v}" for k, v in st["plan"].items())
    stages = " ".join(f"{k} {v:.6f}" for k, v in st["stage_s"].items())
    _log(f"[seed {label}] {' '.join(flags)}: {st['matches']} matches; "
         f"plan {plan}; index build {st['build_s']:.3f} s, query "
         f"{st['query_s']:.3f} s ({st['mbp_per_s']:.2f} Mbp/s); stage s: "
         f"{stages}, host tail {st['host_tail_s']:.6f}; CLI wall "
         f"{wall:.3f} s; peak device memory {st['peak_gib']:.3f} "
         f"GiB; extension kernel launches {st['extend_launches']}, card "
         f"extension tables built 0; table kernel launches "
         f"{st['table_launches']}; suffix sort: {st['sa_sorts']} sort(s)")
    if st["matches"] != want:
        raise AssertionError(f"seed {label}: {st['matches']} matches, "
                             f"expected {want}")
    return st


def _engine_phase(label: str, ref_set, qry_set, cfg, want: int | None,
                  device: str = "cuda"):
    """One run_engine call (native renderer): (listing bytes, its stats).
    On the card it prints the plan, stage seconds and peak device memory.
    Raises if the count is not ``want`` (None: any count above 0)."""
    import torch

    from slamem_tpu_torch.engine.run import run_engine
    from slamem_tpu_torch.report.format import format_matches

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = run_engine(ref_set, qry_set, cfg, device=device)
    text = format_matches(out).encode()
    st = out.stats
    n = st["matches"]
    if (want is None and n == 0) or (want is not None and n != want):
        raise AssertionError(f"{label}: {n} matches, expected "
                             f"{want or '> 0'}")
    if device == "cuda":
        st["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for search in st["searches"]:
            plan = " ".join(f"{k}={search[k]}" for k in
                            ("k", "stride", "rounds", "pairs"))
            stages = " ".join(f"{k} {v:.6f}"
                              for k, v in search["stage_s"].items())
            _log(f"[{label}] {n} matches; plan {plan}; index build "
                 f"{st['index_build_s']:.3f} s, query {st['query_s']:.3f} s;"
                 f" stage s: {stages}; peak device memory "
                 f"{st['peak_gib']:.3f} GiB")
    return text, st


def _native_phase(label: str, rp: str, qp: str, cfg, listing: bytes,
                  smi: str) -> dict:
    """The native host paths at one size: read_fasta (C parser) against
    parse_fasta_bytes (numpy) on the same files, equal FastaSets; then one
    run_engine call and its listing by format_matches (C) against
    format_matches_python, equal bytes, equal to the CLI's listing. Each
    timed."""
    import numpy as np

    from slamem_tpu_torch.engine.run import run_engine
    from slamem_tpu_torch.io.fasta import parse_fasta_bytes, read_fasta
    from slamem_tpu_torch.report.format import (format_matches,
                                                 format_matches_python)

    t0 = time.perf_counter()
    sets = [read_fasta(p) for p in (rp, qp)]
    native_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = [parse_fasta_bytes(Path(p).read_bytes(), p) for p in (rp, qp)]
    plain_read = time.perf_counter() - t0
    for a, b in zip(sets, plain):
        if a.names != b.names or not all(
                np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("starts", "lengths", "codes")):
            raise AssertionError(f"{label}: native FastaSet != numpy's")
    out = run_engine(*sets, cfg, device="cuda")
    t0 = time.perf_counter()
    native = format_matches(out)
    native_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = format_matches_python(out)
    python_render = time.perf_counter() - t0
    if native != python or native.encode() != listing:
        raise AssertionError(f"{label}: native and Python listings differ "
                             "or differ from the CLI's")
    res = {"read_native_s": native_read, "read_numpy_s": plain_read,
           "render_native_s": native_render,
           "render_python_s": python_render, "lines": out.stats["matches"],
           "bytes": len(listing)}
    _log(f"[native {label}] read {native_read:.3f} s (numpy parser "
         f"{plain_read:.3f} s), render {native_render:.3f} s (Python "
         f"{python_render:.3f} s) for {res['lines']} matches, "
         f"{res['bytes']} bytes; FastaSets and listings equal; {smi}")
    return res


def _listing_entries(text: bytes) -> dict:
    """A listing's matches per (query name, reverse) header: sets of
    (reference name or "", 1-based ref pos, 1-based query pos, length)."""
    out: dict = {}
    cur = None
    for line in text.decode().splitlines():
        if line.startswith(">"):
            head = line[1:].split()
            cur = out.setdefault((head[0], head[-1] == "Reverse"
                                  and len(head) > 1), set())
            continue
        f = line.split()
        cur.add((f[0] if len(f) == 4 else "", *map(int, f[-3:])))
    return out


def _oracle_phase(rp: str, qp: str, listings: dict, L: int) -> dict:
    """Phase 4o: the brute-force oracle's matches of every (query, strand)
    entry against the reference text (separators included), MEM then the
    MUM / MAM filters, == each mode's listing, per entry. The diagonals are
    split over a pool of the host's cores (spawned, numpy only; the pool
    ends with the phase)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from slamem_tpu_torch.io.fasta import read_fasta, revcomp_codes
    from slamem_tpu_torch.oracle import filter_mode, find_mems_codes

    ref_set, qry_set = read_fasta(rp), read_fasta(qp)
    rtext, rstarts = ref_set.with_separators()
    names = ref_set.names if len(ref_set.names) > 1 else None
    codes = {}
    for qi, name in enumerate(qry_set.names):
        fwd = qry_set.sequence(qi).codes
        codes[(name, False)], codes[(name, True)] = fwd, revcomp_codes(fwd)
    workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers,
                             mp_context=mp.get_context("spawn")) as pool:
        futures = {}
        for key, c in codes.items():
            cuts = np.linspace(-(len(c) - 1), len(rtext),
                               8 * workers + 1).astype(np.int64)
            futures[key] = [pool.submit(find_mems_codes, rtext, c, L,
                                        range(int(a), int(b)))
                            for a, b in zip(cuts[:-1], cuts[1:])]
        mems = {key: sorted((t for f in fs for t in f.result()),
                            key=lambda t: (t[1], t[0]))
                for key, fs in futures.items()}
    mem_s = time.perf_counter() - t0
    counts = {}
    for mode, text in listings.items():
        got = _listing_entries(text)
        for key, c in codes.items():
            kept = filter_mode(mems[key], rtext, c, mode)
            r = np.array([t[0] for t in kept], np.int64)
            seq, local = ref_set.locate_in_text(r, rstarts)
            want = {(names[s] if names else "", int(lp) + 1, q + 1, ln)
                    for s, lp, (_, q, ln) in zip(seq.tolist(),
                                                 local.tolist(), kept)}
            if got.get(key, set()) != want:
                raise AssertionError(
                    f"4o {mode} {key}: listing != oracle ("
                    f"{len(got.get(key, set()) - want)} extra, "
                    f"{len(want - got.get(key, set()))} missing)")
        counts[mode] = sum(len(v) for v in got.values())
    res = {"oracle_s": mem_s, "total_s": time.perf_counter() - t0,
           "workers": workers, "cells": len(rtext) * sum(
               len(c) for c in codes.values()), "matches": counts}
    _log(f"[oracle 4o] {res['cells']} diagonal cells on {workers} "
         f"processes in {mem_s:.3f} s (modes filtered, total "
         f"{res['total_s']:.3f} s); listings == oracle: {counts}")
    return res


def _mesh_listing(ref_set, qry_set, m) -> bytes:
    """The listing of one engine call's matches on a one-sequence query
    (run_engine's emission order and formatter)."""
    from slamem_tpu_torch.engine import seed_mode
    from slamem_tpu_torch.engine.run import EngineOutput, QueryMatches
    from slamem_tpu_torch.report.format import format_matches

    _, rstarts = ref_set.with_separators()
    order = seed_mode._sort_diag_qstart(m.qpos, m.refpos)
    seq, local = ref_set.locate_in_text(m.refpos[order], rstarts)
    qm = QueryMatches(query_name=qry_set.names[0], reverse=False,
                      ref_seq=seq, ref_pos=local, q_pos=m.qpos[order],
                      length=m.length[order])
    return format_matches(EngineOutput(ref_set.names, [qm], {})).encode()


def _mesh_phase(label: str, fn, index, ref_set, qry_set, cfg, mesh,
                want: int, listing: bytes, smi: str, tap) -> dict:
    """Phase 9b: one engine entry given the one-rank mesh on the card;
    count, listing bytes against ``listing``, stage seconds (``gather`` =
    the collectives), rounds, pairs and peak device memory; one extension
    launch and no extension table (``tap``, and none in
    ``index.derived``)."""
    import torch

    tap.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = fn(index, qry_set.sequence(0).codes, cfg, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tap.check(label)
    if "ext_table" in index.derived:
        raise AssertionError(f"9b {label}: an ext_table was built")
    if "gather" not in m.stats["stage_s"]:
        raise AssertionError(f"9b {label}: no collective ran")
    text = _mesh_listing(ref_set, qry_set, m)
    st = {"matches": int(m.length.size), "wall_s": wall,
          "stage_s": m.stats["stage_s"], "rounds": m.stats["rounds"],
          "pairs": m.stats["pairs"], "k": m.stats["k"],
          "stride": m.stats["stride"],
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    stages = " ".join(f"{k} {v:.6f}" for k, v in st["stage_s"].items())
    _log(f"[mesh {label}] {st['matches']} matches; k={st['k']} "
         f"stride={st['stride']} rounds={st['rounds']} pairs={st['pairs']};"
         f" call {wall:.3f} s; stage s: {stages}; peak device memory "
         f"{st['peak_gib']:.3f} GiB; {smi}")
    if st["matches"] != want or text != listing:
        raise AssertionError(f"9b {label}: {st['matches']} matches "
                             f"(expected {want}) or listing != 6a's")
    return st


_SPAN_LINE = re.compile(r"^\[slamem\] (\w+): ([0-9.]+)s ?(.*)$", re.M)
SCAN_STAGES = ("scan_lcp", "scan_rows", "frontend")


def _span_records(stderr: str) -> dict[str, dict]:
    """The ``-v`` span lines of a CLI run (``[slamem] <phase>: <s>s
    key=value ...``), the last record of each phase by name."""
    out = {}
    for name, sec, rest in _SPAN_LINE.findall(stderr):
        out[name] = {"seconds": float(sec),
                     **dict(re.findall(r"(\w+)=(\S+)", rest))}
    return out


def _lcp_sectors(text, sa, lcp) -> int:
    """32-byte sectors of the text that the LCP kernel's design reads at
    least: those under each suffix's first LCP_WINDOW characters (each
    suffix once, its window cut at the text's end) and, for each long
    pair, those under both suffixes' characters from LCP_WINDOW to the
    one that ends the prefix (cut at the text's end), at the text's real
    address."""
    import torch

    from slamem_tpu_torch.index.lcp import LCP_WINDOW

    n = text.numel()
    base = text.data_ptr()

    def spans(start, stop):
        """Sectors under [start, stop) of the text, 0 where empty."""
        first, last = (base + start) >> 5, (base + stop - 1) >> 5
        return int(torch.where(stop > start, last - first + 1, 0).sum())

    sectors = 0
    for a in range(0, n, 1 << 26):
        pos = torch.arange(a, min(n, a + (1 << 26)), device=text.device)
        sectors += spans(pos, (pos + LCP_WINDOW).clamp(max=n))
    rows = (lcp >= LCP_WINDOW).nonzero()[:, 0]
    h = lcp[rows].to(torch.int64)
    for side in (sa[rows - 1].to(torch.int64), sa[rows].to(torch.int64)):
        sectors += spans(side + LCP_WINDOW, (side + h + 1).clamp(max=n))
    return sectors


def _lcp_kernel_times(index, lcp, long_pairs: int) -> dict:
    """The LCP kernel at this index's shape, by CUDA events: the raw
    launches (pass 1 alone; both passes, the list's length known) into
    buffers of their own, checked == ``lcp``, the wrapper (with its one
    scalar read) and the plain version (``lcp_adjacent_plain``); its byte
    bound (the text, sa and lcp each once: 9 n) and its sector bound (sa
    and lcp, and ``_lcp_sectors``)."""
    import torch

    from slamem_tpu_torch.index.lcp import lcp_adjacent, lcp_adjacent_plain
    from slamem_tpu_torch.kernels.lcp import load_kernel

    text, sa = index.text, index.sa
    n = sa.numel()
    kernel = load_kernel()
    out, longs = torch.empty_like(lcp), torch.empty_like(lcp)
    count = torch.zeros(1, dtype=torch.int32, device=lcp.device)
    stream = torch.cuda.current_stream().cuda_stream

    def first():
        count.zero_()
        if kernel.first(text.data_ptr(), text.numel(), sa.data_ptr(), n,
                        out.data_ptr(), longs.data_ptr(), count.data_ptr(),
                        stream):
            raise RuntimeError("LCP kernel launch failed")

    def both():
        first()
        if long_pairs and kernel.long(text.data_ptr(), text.numel(),
                                      sa.data_ptr(), out.data_ptr(),
                                      longs.data_ptr(), long_pairs, stream):
            raise RuntimeError("LCP kernel's second launch failed")

    first_ms = _cuda_ms(first, 20)
    ms = _cuda_ms(both, 20)
    torch.cuda.synchronize()
    err = _exact("6s LCP kernel, raw launches", (out,), (lcp,))
    wrapper_ms = _cuda_ms(lambda: lcp_adjacent(text, sa), 10)
    plain_ms = _cuda_ms(lambda: lcp_adjacent_plain(text, sa), 1)
    sectors = _lcp_sectors(text, sa, lcp)
    res = {"rows": n, "long_pairs": long_pairs, "ms": ms,
           "first_pass_ms": first_ms, "wrapper_ms": wrapper_ms,
           "plain_ms": plain_ms, "sectors": sectors,
           "sector_bound_bytes": 8 * n + 32 * sectors,
           "sector_bound_ms": (8 * n + 32 * sectors) / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err, **_bound(9 * n, 0)}
    res["bound_share_pct"] = 100.0 * res["bound_ms"] / ms
    res["sector_share_pct"] = 100.0 * res["sector_bound_ms"] / ms
    del out, longs
    return res


def _scan_chr1_phase(cli_main, rank, pack2, label: str, rp: str, qp: str,
                     seed_listing: str, smi: str) -> dict:
    """Phase 6s: ``-engine scan`` at config #5's size on the card. The CLI
    with ``-v`` (stages device-synchronised): listing bytes == the default
    engine's (``seed_listing``, the same files), one scan launch a chunk,
    the LCP kernel's launches == its span's; the three scan stages'
    seconds and fields and the job's peak device memory. Then, on the same
    reference's index, the LCP array == ``benchmark/reference/lcp.py::
    lcp_plain``, the LCP kernel's times and bounds
    (``_lcp_kernel_times``), and the first and last chunks' intervals ==
    its ``intervals_plain``, exactly."""
    import hashlib

    import torch

    from benchmark.reference.lcp import intervals_plain, lcp_plain
    from slamem_tpu_torch.config import Config
    from slamem_tpu_torch.engine import scan_mode, seed_mode
    from slamem_tpu_torch.index.build import build_index
    from slamem_tpu_torch.index.lcp import lcp_adjacent
    from slamem_tpu_torch.io.fasta import read_fasta

    out = seed_listing + ".scan"
    _reset_launches(rank, pack2)
    lcp_adjacent.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stderr = _cli(cli_main, ["-engine", "scan", "-l", str(CHR1_L), "-device",
                             "cuda", "-v", "-o", out, rp, qp])
    torch.cuda.synchronize()
    res = {"wall_s": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    st = _verbose_stats(stderr)
    spans = _span_records(stderr)
    res.update(build_s=st["build_s"], query_s=st["query_s"],
               plan=st["plan"], stage_s=st["stage_s"],
               stages={k: spans[k] for k in SCAN_STAGES})
    res["long_pairs"] = int(spans["scan_lcp"]["long_pairs"])
    res["lcp_launches"] = int(spans["scan_lcp"]["launches"])
    if not lcp_adjacent.launches == res["lcp_launches"] == 1 + (
            res["long_pairs"] > 0):
        raise AssertionError(f"{label}: LCP kernel launches "
                             f"{lcp_adjacent.launches}, span "
                             f"{res['lcp_launches']}, long pairs "
                             f"{res['long_pairs']}")
    chunks = int(spans["frontend"]["chunks"])
    res["scan_launches"] = _scan_launches(rank, "nib", chunks, label)
    got, want = Path(out).read_bytes(), Path(seed_listing).read_bytes()
    res["sha256"] = hashlib.sha256(got).hexdigest()
    res["seed_sha256"] = hashlib.sha256(want).hexdigest()
    res["matches"] = len(_listing_matches(out))
    _log(f"[scan {label}] -engine scan -l {CHR1_L}: {res['matches']} lines "
         f"of matches, {len(got)} B, sha256 {res['sha256']}; index build "
         f"{st['build_s']} s, query {st['query_s']} s; stages (synchronised"
         f"): " + "; ".join(
             f"{k} {spans[k]['seconds']:.6f} s "
             + " ".join(f"{f}={v}" for f, v in spans[k].items()
                        if f != "seconds") for k in SCAN_STAGES)
         + f"; plan {st['plan']}; stage s {st['stage_s']}; CLI wall "
         f"{res['wall_s']:.3f} s; "
         f"peak device memory {res['peak_bytes']} B "
         f"({res['peak_bytes'] / 2**30:.3f} GiB); lcp_adjacent: "
         f"{res['long_pairs']} long pairs, {res['lcp_launches']} launches; "
         f"{chunks} scan launches; {smi}")
    if got != want:
        raise AssertionError(f"{label}: the scan listing != the default "
                             "engine's")
    _log(f"[scan {label}] listing == the default engine's (sha256 "
         f"{res['seed_sha256']})")
    os.remove(out)

    # the mechanism against the plain reference on the same index
    rtext = read_fasta(rp).with_separators()[0]
    qcodes = read_fasta(qp).sequence(0).codes
    index = build_index(rtext, Config.occ_block, "cuda")
    del rtext
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lcp = lcp_adjacent(index.text, index.sa, stats)
    torch.cuda.synchronize()
    res["lcp_adjacent_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = lcp_plain(index.text, index.sa)
    torch.cuda.synchronize()
    res["lcp_plain_s"] = time.perf_counter() - t0
    if not torch.equal(lcp, plain):
        bad = int((lcp != plain).sum())
        raise AssertionError(f"{label}: lcp_adjacent != lcp_plain at {bad} "
                             f"of {index.n} rows")
    res["lcp_max"] = int(plain.max())
    del plain
    _log(f"[scan {label}] lcp_adjacent == lcp_plain over {index.n} rows "
         f"(max {res['lcp_max']}, {stats['long_pairs']} long pairs, "
         f"{stats['launches']} launches); {res['lcp_adjacent_s']:.6f} s "
         f"against {res['lcp_plain_s']:.6f} s")
    k = res["lcp_kernel"] = _lcp_kernel_times(index, lcp,
                                              stats["long_pairs"])
    del lcp
    _log(f"[scan {label}] LCP kernel at {k['rows']} rows: {k['ms']:.6f} ms "
         f"(pass 1 {k['first_pass_ms']:.6f} ms; "
         f"{k['sector_share_pct']:.1f}% of the sector bound "
         f"{k['sector_bound_ms']:.6f} ms, {k['sectors']} sectors; "
         f"{k['bound_share_pct']:.1f}% of the byte bound "
         f"{k['bound_ms']:.6f} ms), wrapper {k['wrapper_ms']:.6f} ms, "
         f"plain {k['plain_ms']:.6f} ms; {smi}")
    qt = seed_mode.query_to_device(qcodes, "cuda")[1]
    m, C = int(qt.numel()), scan_mode._SCAN_CHUNK
    res["chunks_checked"] = {}
    for a in sorted({0, (m - 1) // C * C}):
        piece = qt[a:a + C + CHR1_L]
        take = min(C, m - a)
        lo, w = (x[:take] for x in scan_mode.scan_intervals(
            index, piece, CHR1_L))
        t0 = time.perf_counter()
        plo, pw = (x[:take] for x in intervals_plain(
            index.text, index.sa, piece, CHR1_L))
        torch.cuda.synchronize()
        hit = pw > 0
        if not (torch.equal(w, pw) and torch.equal(lo[hit], plo[hit])):
            raise AssertionError(f"{label}: chunk at {a}: scan intervals != "
                                 "intervals_plain")
        res["chunks_checked"][a] = {"positions": take,
                                    "hits": int(hit.sum()),
                                    "pairs": int(pw.sum()),
                                    "plain_s": time.perf_counter() - t0}
    _log(f"[scan {label}] scan intervals == intervals_plain on chunks "
         f"{res['chunks_checked']}")
    del index, qt
    torch.cuda.empty_cache()
    return res


def scan_chr1_main(argv: list[str]) -> int:
    """``python3 chip_smoke.py --scan-chr1 [--bench-seed N]``: phase 6a's
    default call and phase 6s alone, on phase 6's inputs or, with
    ``--bench-seed``, on the benchmark's ``chr1-pair`` inputs for that seed
    (the files and listing of cells ``chr1-pair.job`` and
    ``chr1-pair.scan-job`` at that seed)."""
    import argparse
    import hashlib

    import torch

    ap = argparse.ArgumentParser(prog="chip_smoke.py --scan-chr1")
    ap.add_argument("--scan-chr1", action="store_true")
    ap.add_argument("--bench-seed", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA card", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from slamem_tpu_torch.cli.main import main as cli_main
    from slamem_tpu_torch.io.fasta import Sequence, write_fasta
    from slamem_tpu_torch.kernels import (buckets, extend, lcp, occ, rank,
                                          sakeys, seedkeys, unpack2)
    from slamem_tpu_torch.utils import pack2, synth

    # every kernel the two calls launch, built first, so that no stage
    # below holds an nvcc run
    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(m.load_kernel) for m in (
                rank, unpack2, extend, seedkeys, buckets, occ, sakeys, lcp)]:
            f.result()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"[device] {torch.cuda.get_device_name(0)}; torch "
         f"{torch.__version__} cuda {torch.version.cuda}; {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        rp, qp = os.path.join(tmp, "ref.fa"), os.path.join(tmp, "qry.fa")
        seed_out = os.path.join(tmp, "seed.txt")
        t0 = time.perf_counter()
        if args.bench_seed is None:
            ref, qry = synth.strain_pair(CHR1["n"], seed=CHR1["seed"],
                                         sub_rate=CHR1["sub_rate"],
                                         indel_rate=CHR1["indel_rate"])
            write_fasta(rp, [Sequence("ref", ref)])
            write_fasta(qp, [Sequence("qry", qry[:CHR1_QUERY_BP])])
            del ref, qry
        else:
            from benchmark.harness.fasta import write_fasta as bench_fasta
            from benchmark.harness.manifest import load_cell
            from benchmark.inputs.build import make_inputs

            config = load_cell("chr1-pair.job").config
            inp = make_inputs(config, args.bench_seed, torch.device("cuda"))
            bench_fasta(rp, inp.ref_names, inp.refs)
            bench_fasta(qp, inp.query_names, inp.queries)
            del inp
        _log(f"[chr1] inputs made and written in "
             f"{time.perf_counter() - t0:.3f} s (bench seed "
             f"{args.bench_seed})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stderr = _cli(cli_main, ["-l", str(CHR1_L), "-device", "cuda", "-v",
                                 "-o", seed_out, rp, qp])
        torch.cuda.synchronize()
        st = _verbose_stats(stderr)
        listing = Path(seed_out).read_bytes()
        _log(f"[seed 6a] default call: {len(listing)} B, sha256 "
             f"{hashlib.sha256(listing).hexdigest()}; index build "
             f"{st['build_s']} s, query {st['query_s']} s, stage s "
             f"{st['stage_s']}; CLI wall {time.perf_counter() - t0:.3f} s;"
             f" peak device memory {torch.cuda.max_memory_allocated()} B")
        res = _scan_chr1_phase(cli_main, rank, pack2, "6s", rp, qp,
                               seed_out, smi)
    print(json.dumps({"scan_chr1": res, "bench_seed": args.bench_seed},
                     sort_keys=True, default=str), flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    try:
        import slamem_tpu_torch
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository (no "
              "slamem_tpu_torch beside it)", file=sys.stderr)
        return 1
    if Path(slamem_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: slamem_tpu_torch does not come from this "
              "checkout", file=sys.stderr)
        return 1

    from slamem_tpu_torch.cli.main import main as cli_main
    from slamem_tpu_torch.config import Config, MatchMode
    from slamem_tpu_torch.engine import scan_mode, seed_mode
    from slamem_tpu_torch.index import build as index_build
    from slamem_tpu_torch.index import serialize
    from slamem_tpu_torch.index.build import build_index
    from slamem_tpu_torch.io.fasta import Sequence, read_fasta, write_fasta
    from slamem_tpu_torch.kernels import (buckets, extend, lcp, occ, rank,
                                          sakeys, seedkeys, unpack2)
    from slamem_tpu_torch.utils import pack2, synth

    tap = _ExtendTap(seed_mode)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"[device] {kind}; torch {torch.__version__} cuda "
         f"{torch.version.cuda}")
    _log(smi)

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        builds = {"rank and scan kernels": pool.submit(rank.load_kernel),
                  "unpack kernel": pool.submit(unpack2.load_kernel),
                  "extension kernel": pool.submit(extend.load_kernel),
                  "key kernels": pool.submit(seedkeys.load_kernel),
                  "bucket kernel": pool.submit(buckets.load_kernel),
                  "occ kernel": pool.submit(occ.load_kernel),
                  "window-key kernel": pool.submit(sakeys.load_kernel),
                  "LCP kernel": pool.submit(lcp.load_kernel)}
        built = {label: f.result() for label, f in builds.items()}
    _log(f"[build] {', '.join(f'{k} {v.path.name}' for k, v in built.items())}"
         f" in {time.perf_counter() - t0:.3f} s")
    for lib in built.values():
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                _log(f"[build] {line.strip()}")

    # o. the index build's occ checkpoint kernel at chr1's size
    occ_o = _phase_o(index_build)
    # k. the suffix sort's window-key kernel at chr1's size
    keys_k = _phase_k(index_build)

    # 2. each kernel vs its plain version on the headline reference's
    # tables, at the scan's batch shape, and on a table larger than L2
    ref, qry = synth.strain_pair(HEADLINE["n"], seed=HEADLINE["seed"],
                                 sub_rate=HEADLINE["sub_rate"],
                                 indel_rate=HEADLINE["indel_rate"])
    index = build_index(ref, device="cuda")
    n = index.n
    gen = torch.Generator(device="cuda").manual_seed(HEADLINE["seed"])
    rand_pos = torch.randint(0, n + 1, (RANDOM_QUERIES,), generator=gen,
                             device="cuda", dtype=torch.int32)
    rand_c = torch.randint(0, 4, (RANDOM_QUERIES,), generator=gen,
                           device="cuda", dtype=torch.int32)
    bwt_big = torch.randint(0, 4, (200_000_000,), generator=gen,
                            device="cuda", dtype=torch.uint8)
    pos_big = torch.randint(0, bwt_big.numel() + 1, (RANDOM_QUERIES,),
                            generator=gen, device="cuda", dtype=torch.int32)
    # the scan engine's batch: 2 occ queries per lane, one lane per 256
    # query positions of a chunk of at most _SCAN_CHUNK positions
    lanes = -(-min(len(qry), scan_mode._SCAN_CHUNK) // 256)
    checks = {}
    for name, rows, build, per_row in (
            ("rank_rows", rank.interleaved_rows(index), rank._build_rows,
             rank.SYMS_PER_ROW),
            ("rank_rows_nib", rank.nibble_rows(index), rank._build_rows_nib,
             rank.NIB_PER_ROW)):
        span = rows.shape[0] * per_row
        edge = torch.tensor(sorted({0, 1, per_row - 1, per_row, per_row + 1,
                                    2 * per_row - 1, 2 * per_row, n - 1, n,
                                    span - 1}), dtype=torch.int32,
                            device="cuda")
        positions = torch.cat([rand_pos, edge.repeat_interleave(4)])
        chars = torch.cat([rand_c, torch.arange(
            4, dtype=torch.int32, device="cuda").repeat(edge.numel())])
        big = _kernel_vs_plain(rank, name, rows, chars, positions,
                               "random + edges, 5 Mbp table")
        shape = _kernel_vs_plain(rank, name, rows,
                                 chars[:2 * lanes].contiguous(),
                                 positions[:2 * lanes].contiguous(),
                                 "scan batch shape, 5 Mbp table")
        rows_big = build(bwt_big)
        hbm = _kernel_vs_plain(rank, name, rows_big, rand_c, pos_big,
                               f"random, 200 M-symbol table "
                               f"({rows_big.numel() * 4} B > L2)")
        turns = {"5 Mbp": _edges_exact(rank, name, rows, n, per_row,
                                       "5 Mbp table"),
                 "200 M-symbol": _edges_exact(rank, name, rows_big,
                                              bwt_big.numel(), per_row,
                                              "200 M-symbol table")}
        _log(f"[rank] {name}: turn edges (per_row/2 - 1, per_row/2, "
             f"per_row/2 + 1 of every row, the last row past n) == plain: "
             f"{turns}")
        checks[name] = {"big": big, "shape": shape, "hbm": hbm}
        del rows, rows_big

    # 2w. the index-level drop-ins (rank_nib at every width, rank_pallas,
    # rank_xla) == rank_batch on the headline index and on an index over
    # the 200 M-symbol BWT; each kernel == plain, timed; backward_step;
    # the demo twin on the card
    edges = {0, 1, n - 1, n}
    for per in [rank.SYMS_PER_ROW] + [(w - rank.CNT_WORDS) * 8
                                      for w in NIB_WIDTHS]:
        for b in range(n // per + 1):
            edges.update(b * per + d for d in (-1, 0, 1, per // 2))
    edge = torch.tensor(sorted(e for e in edges if 0 <= e <= n),
                        dtype=torch.int32, device="cuda")
    big_index = _bwt_index(bwt_big)
    drop = _phase_2w(rank, index_build, pack2, {
        "5 Mbp index": (index, torch.cat([rand_c, torch.arange(
            4, dtype=torch.int32, device="cuda").repeat(edge.numel())]),
                        torch.cat([rand_pos, edge.repeat_interleave(4)])),
        "200 M-symbol index": (big_index, rand_c, pos_big)})
    del big_index, edge
    drop["backward_step"] = _backward_steps(index_build, serialize, index,
                                            ref)
    drop["demo"] = _demo(here)
    del bwt_big, pos_big, rand_pos, rand_c

    # u. the packed upload wire at config #5's sizes
    wire = _phase_u(pack2, seed_mode)

    # 2s. the scan kernel on one full 4M chunk of the headline query, as
    # find_scan_matches cuts it, against the plain lockstep loop
    chunk = seed_mode.query_to_device(qry, "cuda")[1][
        :scan_mode._SCAN_CHUNK + HEADLINE_L]
    scans = {layout: _scan_kernel_vs_plain(rank, scan_mode, index, chunk,
                                           layout, HEADLINE_L, 256)
             for layout in ("nib", "k0")}
    if scans["nib"]["attempts"] != scans["k0"]["attempts"]:
        raise AssertionError("2s: the two layouts' plain loops made "
                             "different attempts")
    del chunk, index
    torch.cuda.synchronize()
    n_chunks = -(-len(seed_mode.pad_query(qry)) // scan_mode._SCAN_CHUNK)

    with tempfile.TemporaryDirectory() as tmp:
        # 3. the scan slice end to end at the headline input (rank_kernel
        # "auto": the nibble kernel)
        rp, qp, out = (os.path.join(tmp, f) for f in
                       ("ref.fa", "qry.fa", "scan.txt"))
        write_fasta(rp, [Sequence("ref", ref)])
        write_fasta(qp, [Sequence("qry", qry)])
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(rank, pack2)
        t0 = time.perf_counter()
        stderr = _cli(cli_main, ["-engine", "scan", "-l", str(HEADLINE_L),
                                 "-device", "cuda", "-v", "-o", out, rp, qp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"scan_lanes_nib": _scan_launches(rank, "nib",
                                                     n_chunks, "3")}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        stats = _verbose_stats(stderr)
        matches = _listing_matches(out)
        _log(f"[slice] 5 Mbp scan -l {HEADLINE_L}: {len(matches)} matches; "
             f"index build {stats['build_s']} s, query {stats['query_s']} s "
             f"({stats['mbp_per_s']} Mbp/s), stage s {stats['stage_s']}, "
             f"CLI wall {wall:.3f} s; scan kernel (nibble table) launches "
             f"{launches['scan_lanes_nib']} == chunks, standalone rank "
             f"kernel launches 0; peak device memory {peak_gib:.3f} GiB")
        if len(matches) != HEADLINE_MATCHES:
            raise AssertionError(f"{len(matches)} matches, expected "
                                 f"{HEADLINE_MATCHES}")
        _check_maximal(ref, qry, matches)
        _log("[slice] every match exact and maximal")

        # 3k. the same scan with rank_kernel="pallas": the K0 table
        _reset_launches(rank, pack2)
        t0 = time.perf_counter()
        k0_text, k0_st = _engine_phase(
            "k0 3k", read_fasta(rp), read_fasta(qp),
            Config(engine="scan", rank_kernel="pallas",
                   min_length=HEADLINE_L), HEADLINE_MATCHES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["scan_lanes_k0"] = _scan_launches(rank, "k0", n_chunks,
                                                   "3k")
        _log(f"[k0 3k] 5 Mbp scan -l {HEADLINE_L}, rank_kernel=pallas: "
             f"{k0_st['matches']} matches; query {k0_st['query_s']:.3f} s, "
             f"wall {wall:.3f} s; scan kernel (K0 table) launches "
             f"{launches['scan_lanes_k0']} == chunks, standalone rank "
             f"kernel launches 0")
        if k0_text != Path(out).read_bytes():
            raise AssertionError("3k: K0 scan listing != phase 3's")
        _log("[k0 3k] listing == phase 3's nibble-table scan listing")

        # 3p. the device's busy share of a warm 5 Mbp scan query
        index = build_index(ref, device="cuda")
        cfg = Config(engine="scan", min_length=HEADLINE_L)
        scan_mode.find_scan_matches(index, qry, cfg)
        prof = _busy_share(
            lambda: scan_mode.find_scan_matches(index, qry, cfg))
        _log(f"[profile 3p] warm 5 Mbp scan query: {prof['wall_s']:.6f} s, "
             f"{prof['device_events']} device events, device busy "
             f"{prof['busy_s']:.6f} s = {prof['busy_share']} of the call; "
             f"{smi}")
        del index

        # 4. GPU == CPU listing bytes, multi-FASTA with N runs, both strands
        # planted repeats make some MEMs non-unique, so -mum/-mam filter
        base = synth.with_n_runs(synth.with_repeats(
            synth.random_genome(200_000, seed=11), 20, 400, seed=15), 6, 40,
            seed=12)
        refs = [base[:90_000], base[90_000:160_000], base[160_000:]]
        mut = synth.with_n_runs(synth.mutate(base, 0.015, 0.0015, seed=13),
                                4, 30, seed=14)
        qrys = [mut[20_000:80_000], mut[120_000:160_000]]
        rp2, qp2 = os.path.join(tmp, "ref2.fa"), os.path.join(tmp, "qry2.fa")
        write_fasta(rp2, [Sequence(f"chr{i}", s) for i, s in enumerate(refs)])
        write_fasta(qp2, [Sequence(f"read{i}", s) for i, s in enumerate(qrys)])
        bytes_cpu = {}
        for engine in (["-engine", "scan"], []):     # 4. scan; 5e. seed
            for mode in ([], ["-mum"], ["-mam"]):
                texts = {}
                for dev in ("cuda", "cpu"):
                    o = os.path.join(tmp, f"out_{dev}.txt")
                    _cli(cli_main, [*engine, "-b", "-l", "20", *mode,
                                    "-device", dev, "-o", o, rp2, qp2])
                    texts[dev] = Path(o).read_bytes()
                nm = len(_listing_matches(os.path.join(tmp, "out_cpu.txt")))
                if texts["cuda"] != texts["cpu"] or nm == 0:
                    raise AssertionError(
                        f"{' '.join(engine) or 'seed'} -b {' '.join(mode)}: "
                        f"GPU and CPU listings differ or are empty ({nm})")
                _log(f"[bytes] {' '.join(engine) or 'default engine (seed)'}"
                     f" -b {' '.join(mode) or '-mem'}: {nm} matches, "
                     f"{len(texts['cpu'])} bytes, GPU == CPU")
                bytes_cpu.setdefault(tuple(mode), []).append(texts["cpu"])
        for mode, (scan_b, seed_b) in bytes_cpu.items():
            if scan_b != seed_b:
                raise AssertionError(f"-b {' '.join(mode)}: seed listing != "
                                     "scan listing")
        _log("[bytes] seed listings == scan listings (-b, -mum, -mam)")
        # 4o. nothing missing, nothing extra: the brute-force oracle
        _oracle_phase(rp2, qp2, {
            "mem": bytes_cpu[()][0], "mum": bytes_cpu[("-mum",)][0],
            "mam": bytes_cpu[("-mam",)][0]}, 20)

        # 4k. K0 on a path: the scan with rank_kernel="pallas" at 200 kbp
        sets2 = (read_fasta(rp2), read_fasta(qp2))
        modes = {(): MatchMode.MEM, ("-mum",): MatchMode.MUM,
                 ("-mam",): MatchMode.MAM}
        _reset_launches(rank, pack2)
        k0_bytes = {mode: _engine_phase("k0", *sets2, Config(
            engine="scan", rank_kernel="pallas", both_strands=True,
            min_length=20, mode=mm), None)[0] for mode, mm in modes.items()}
        k0_4k = rank.scan_lanes.launches["k0"]
        _log(f"[k0 4k] -engine scan rank_kernel=pallas -b, MEM/MUM/MAM: "
             f"scan kernel launches {rank.scan_lanes.launches}, standalone "
             f"rank kernel launches "
             f"{rank.rank_rows.launches + rank.rank_rows_nib.launches}")
        if k0_4k <= 0 or rank.scan_lanes.launches["nib"] or \
                rank.rank_rows.launches or rank.rank_rows_nib.launches:
            raise AssertionError("the K0 scan did not run on the K0 table "
                                 "alone")
        for mode, text in k0_bytes.items():
            if text != bytes_cpu[mode][0]:
                raise AssertionError(f"K0 scan -b {' '.join(mode)}: listing "
                                     "!= the nibble scan's")
        _log("[k0 4k] listings == phase 4's nibble-kernel scan listings "
             "(-b, -mum, -mam)")

        # 7c, 7d. the boundary backend at 200 kbp
        for engine in ("scan", "seed"):
            for mode, mm in modes.items():
                cfg = Config(engine=engine, match_backend="boundary",
                             both_strands=True, min_length=20, mode=mm)
                texts = {dev: _engine_phase(f"boundary 7c {engine}", *sets2,
                                            cfg, None, dev)[0]
                         for dev in ("cuda", "cpu")}
                if not texts["cuda"] == texts["cpu"] == bytes_cpu[mode][0]:
                    raise AssertionError(
                        f"boundary {engine} -b {' '.join(mode)}: GPU, CPU "
                        "and sort listings differ")
                _log(f"[boundary 7c] {engine} -b {' '.join(mode) or '-mem'}:"
                     f" {len(texts['cpu'])} bytes, GPU == CPU == sort")
        text, st = _engine_phase("boundary 7d", *sets2, Config(
            match_backend="boundary", both_strands=True, min_length=20,
            pair_capacity=4096), None)
        rounds = st["searches"][0]["rounds"]
        if text != bytes_cpu[()][0] or rounds < 2:
            raise AssertionError(f"boundary 7d: {rounds} rounds; listing "
                                 "!= one round's")
        _log(f"[boundary 7d] pair_capacity 4096: {rounds} rounds == one "
             "round")

        # 5a-5d. the default engine at the bench's sizes
        seed_out = os.path.join(tmp, "seed.txt")
        _reset_launches(rank, pack2)
        seed = {"5a": _seed_phase(cli_main, tap, "5a",
                                  ["-l", str(HEADLINE_L)], HEADLINE_MATCHES,
                                  rp, qp, seed_out)}
        launches["extend_runs"] = seed["5a"]["extend_launches"]
        launches.update(seed["5a"]["table_launches"])
        # the wire: the 5 Mbp reference's upload and the query's
        launches["unpack_codes"] = pack2.unpack_codes.launches
        _log(f"[seed 5a] unpack kernel launches "
             f"{launches['unpack_codes']} (reference and query uploads)")
        if launches["unpack_codes"] != 2:
            raise AssertionError("5a: the uploads did not launch the unpack "
                                 "kernel once each")
        if Path(seed_out).read_bytes() != Path(out).read_bytes():
            raise AssertionError("5a: seed listing != phase 3's scan listing")
        _check_maximal(ref, qry, _listing_matches(seed_out))
        _log("[seed 5a] listing == scan listing; every match exact and "
             "maximal")
        # 9a. the CLI under the launcher variables: it joins a one-rank
        # NCCL group (rank 0 on cuda:0), plain and -shard
        import torch.distributed as dist

        launcher = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
                    "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0"}
        os.environ.update(launcher)
        mesh_out = os.path.join(tmp, "mesh.txt")
        mesh_runs = {}
        for label, flags in (("9a", []), ("9a -shard", ["-shard"])):
            mesh_runs[label] = _seed_phase(
                cli_main, tap, label, [*flags, "-l", str(HEADLINE_L)],
                HEADLINE_MATCHES, rp, qp, mesh_out)
            if Path(mesh_out).read_bytes() != Path(seed_out).read_bytes():
                raise AssertionError(f"{label}: listing != 5a's")
        for var in launcher:
            del os.environ[var]
        if not (dist.is_initialized() and dist.get_backend() == "nccl"
                and dist.get_world_size() == 1
                and torch.cuda.current_device() == 0):
            raise AssertionError("9a: the CLI did not join a one-rank NCCL "
                                 "group on cuda:0")
        _log(f"[mesh 9a] launcher variables: backend "
             f"{dist.get_backend()}, world {dist.get_world_size()}, rank "
             f"{dist.get_rank()} on cuda:{torch.cuda.current_device()}; "
             "plain and -shard listings == 5a's")
        # 7a. the boundary backend at 5a
        boundary = {}
        text, boundary["7a"] = _engine_phase(
            "boundary 7a", read_fasta(rp), read_fasta(qp),
            Config(min_length=HEADLINE_L, match_backend="boundary"),
            HEADLINE_MATCHES)
        if text != Path(seed_out).read_bytes():
            raise AssertionError("7a: boundary listing != 5a's")
        _log("[boundary 7a] listing == 5a's")
        seed["5b"] = _seed_phase(cli_main, tap, "5b", ["-mam", "-l",
                                                  str(HEADLINE_L)],
                                 MAM_MATCHES, rp, qp, seed_out)
        strains = [Sequence(f"strain{j}", synth.mutate(
            ref, 0.01 + 0.001 * j, 0.001, seed=100 + j))
            for j in range(STRAINS)]
        qp3 = os.path.join(tmp, "strains.fa")
        write_fasta(qp3, strains)
        del strains
        seed["5d"] = _seed_phase(cli_main, tap, "5d",
                                 ["-l", str(STRAINS_L)], STRAINS_MATCHES, rp,
                                 qp3, seed_out, buckets=0)
        replays = {"5d": tap.take()}   # its merged runs, for phase e
        # t. the seed tables' kernels against their plain versions at the
        # 5 Mbp index (5a's table and query, 5d's table, two-word keys)
        index = build_index(ref, device="cuda")
        plan = {lb: (int(seed[lb]["plan"]["k"]),
                     int(seed[lb]["plan"]["stride"])) for lb in ("5a", "5d")}
        tables = {}
        for label, k in (("5a", plan["5a"][0]), ("5d", plan["5d"][0]),
                         ("K=20", 20)):
            tables[f"{label} seed table"] = _seed_table_t(seed_mode, label,
                                                          index, k)
            if label == "5d":      # the join frontend: no bucket table
                continue
            refk = seed_mode.seed_table_rows(index.text, index.sa, k)[0]
            bbits, shift = _direct_bucket_plan(index, k)
            tables[f"{label} bucket starts"] = _bucket_t(
                seed_mode, label, k, bbits, shift, [(refk, 0, index.n)])
            del refk
        index.derived.clear()
        tables["K=20 bucket starts"]["probes"] = seed_mode.bucket_table(
            index, 20)[2]
        tables["5a key pack"] = _pack_t(
            seed_mode, "5a", seed_mode.query_to_device(qry, "cuda")[1],
            *plan["5a"])
        del index
        ref, qry = synth.strain_pair(CHR21["n"], seed=CHR21["seed"],
                                     sub_rate=CHR21["sub_rate"],
                                     indel_rate=CHR21["indel_rate"])
        write_fasta(rp, [Sequence("ref", ref)])
        write_fasta(qp, [Sequence("qry", qry)])
        seed["5c"] = _seed_phase(cli_main, tap, "5c",
                                 ["-l", str(CHR21_L)], CHR21_MATCHES, rp, qp,
                                 seed_out)
        _check_maximal(ref, qry, _listing_matches(seed_out))
        _log("[seed 5c] every match exact and maximal")
        # 3c. the scan engine on the 40 Mbp pair (LCP array > L2)
        scan40 = os.path.join(tmp, "scan40.txt")
        _reset_launches(rank, pack2)
        t0 = time.perf_counter()
        stderr = _cli(cli_main, ["-engine", "scan", "-l", str(CHR21_L),
                                 "-device", "cuda", "-v", "-o", scan40, rp,
                                 qp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunks40 = -(-len(seed_mode.pad_query(qry)) // scan_mode._SCAN_CHUNK)
        n40 = _scan_launches(rank, "nib", chunks40, "3c")
        st40 = _verbose_stats(stderr)
        n_scan40 = len(_listing_matches(scan40))
        _log(f"[scan 3c] 40 Mbp scan -l {CHR21_L}: {n_scan40} matches; index "
             f"build {st40['build_s']} s, query {st40['query_s']} s "
             f"({st40['mbp_per_s']} Mbp/s), stage s {st40['stage_s']}, CLI "
             f"wall {wall:.3f} s; scan kernel launches {n40} == chunks")
        if n_scan40 != CHR21_MATCHES:
            raise AssertionError(f"3c: {n_scan40} matches, expected "
                                 f"{CHR21_MATCHES}")
        if Path(scan40).read_bytes() != Path(seed_out).read_bytes():
            raise AssertionError("3c: scan listing != 5c's seed listing")
        _log("[scan 3c] listing == 5c's")
        st40["frontend_split"] = _scan_frontend_split(
            rank, scan_mode, seed_mode, build_index(ref, device="cuda"), qry,
            CHR21_L)
        torch.cuda.synchronize()
        _log("[seed] " + json.dumps(seed, sort_keys=True))
        # 7b. the boundary backend at 5c; 8. the native host paths at 5c
        sets = (read_fasta(rp), read_fasta(qp))
        for key, cap in (("7b", Config.pair_capacity),
                         ("7b rounds", BOUNDARY_ROUNDS_CAPACITY)):
            text, boundary[key] = _engine_phase(
                f"boundary {key}", *sets, Config(
                    min_length=CHR21_L, match_backend="boundary",
                    pair_capacity=cap), CHR21_MATCHES)
            if text != Path(seed_out).read_bytes():
                raise AssertionError(f"{key}: boundary listing != 5c's")
            _log(f"[boundary {key}] pair_capacity {cap}: "
                 f"{boundary[key]['searches'][0]['rounds']} round(s); "
                 "listing == 5c's")
        if boundary["7b rounds"]["searches"][0]["rounds"] < 2:
            raise AssertionError("7b: the smaller capacity ran one round")
        del sets
        _log("[boundary] " + json.dumps(boundary, sort_keys=True))
        native = {"5c": _native_phase("5c", rp, qp,
                                      Config(min_length=CHR21_L),
                                      Path(seed_out).read_bytes(), smi)}

        # 6c. the virtual-slab program at 200 kbp: GPU == CPU == default
        for mode in ([], ["-mum"], ["-mam"]):
            texts = {}
            for dev in ("cuda", "cpu"):
                o = os.path.join(tmp, f"out_{dev}.txt")
                _cli(cli_main, ["-shard", "-slabs", "3", "-b", "-l", "20",
                                *mode, "-device", dev, "-o", o, rp2, qp2])
                texts[dev] = Path(o).read_bytes()
            if not texts["cuda"] == texts["cpu"] == bytes_cpu[tuple(mode)][1]:
                raise AssertionError(f"-shard -slabs 3 -b {' '.join(mode)}: "
                                     "GPU, CPU and default listings differ")
            _log(f"[shard 6c] -shard -slabs 3 -b {' '.join(mode) or '-mem'}"
                 f": {len(texts['cpu'])} bytes, GPU == CPU == default call")
        o = os.path.join(tmp, "out_shard.txt")
        _cli(cli_main, ["-shard", "-b", "-l", "20", "-device", "cuda", "-o",
                        o, rp2, qp2])
        if Path(o).read_bytes() != bytes_cpu[()][1]:
            raise AssertionError("-shard -b: listing != the default call's")
        _log("[shard 6c] -shard -b (one slab: replicated) == default call")

        # 6a, 6b. BASELINE config #5 at the JAX bench's size
        t0 = time.perf_counter()
        ref, qry = synth.strain_pair(CHR1["n"], seed=CHR1["seed"],
                                     sub_rate=CHR1["sub_rate"],
                                     indel_rate=CHR1["indel_rate"])
        qry = qry[:CHR1_QUERY_BP]
        write_fasta(rp, [Sequence("ref", ref)])
        write_fasta(qp, [Sequence("qry", qry)])
        _log(f"[chr1] inputs {len(ref)} + {len(qry)} bp made and written in "
             f"{time.perf_counter() - t0:.3f} s")
        _log(smi)
        chr1 = {"6a": _seed_phase(cli_main, tap, "6a", ["-l", str(CHR1_L)],
                                  CHR1_MATCHES, rp, qp, seed_out)}
        replays["6a"] = tap.take()
        peak = round(chr1["6a"]["peak_gib"] * 2**30)
        _log(f"[chr1 6a] suffix sort: {chr1['6a']['sa_sorts']} sort(s); "
             f"peak device memory {peak} B (at most {CHR1_PEAK_BYTES})")
        if peak > CHR1_PEAK_BYTES:
            raise AssertionError(f"6a: peak device memory {peak} B > "
                                 f"{CHR1_PEAK_BYTES}")
        _check_maximal(ref, qry, _listing_matches(seed_out))
        _log("[chr1 6a] every match exact and maximal")
        del ref, qry
        native["6a"] = _native_phase("6a", rp, qp, Config(min_length=CHR1_L),
                                     Path(seed_out).read_bytes(), smi)
        _log("[native] " + json.dumps(native, sort_keys=True))
        shard_out = os.path.join(tmp, "shard.txt")
        chr1["6b"] = _seed_phase(
            cli_main, tap, "6b", ["-shard", "-slabs", str(CHR1_SLABS), "-l",
                             str(CHR1_L)], CHR1_MATCHES, rp, qp, shard_out,
            buckets=CHR1_SLABS)
        if Path(shard_out).read_bytes() != Path(seed_out).read_bytes():
            raise AssertionError("6b: -shard -slabs listing != 6a's")
        _log(f"[chr1 6b] {CHR1_SLABS}-slab listing == replicated listing")
        # 6s. the scan engine at config #5's size, held to 6a's listing
        # and to the plain reference of its LCP array and intervals
        chr1["6s"] = _scan_chr1_phase(cli_main, rank, pack2, "6s", rp, qp,
                                      seed_out, smi)
        _log("[chr1] " + json.dumps(chr1, sort_keys=True, default=str))

        # 9b. config #5 through the replicated engine on the one-rank
        # mesh and the sharded mesh branch over the NCCL group
        from slamem_tpu_torch.dist import sharded
        from slamem_tpu_torch.dist.mesh import make_mesh

        mesh = make_mesh(1, "cuda")
        if mesh.group is None or mesh.device != torch.device("cuda", 0):
            raise AssertionError("9b: no one-rank group on cuda:0")
        sets = (read_fasta(rp), read_fasta(qp))
        rtext = sets[0].with_separators()[0]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sorts = index_build.suffix_array.sorts
        t0 = time.perf_counter()
        index = build_index(rtext, Config.occ_block, "cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated() - held
        _log(f"[chr1 9b] the index build alone: {build_s:.6f} s, "
             f"{index_build.suffix_array.sorts - sorts} sort(s), its own "
             f"peak {build_peak} B ({build_peak / 2**30:.3f} GiB) over the "
             f"{held} B held before it; {smi}")
        del rtext
        for label, fn in (
                ("9b replicated", seed_mode.find_seed_matches),
                ("9b sharded", sharded.find_seed_matches_sharded_mesh)):
            mesh_runs[label] = _mesh_phase(
                label, fn, index, *sets, Config(min_length=CHR1_L), mesh,
                CHR1_MATCHES, Path(seed_out).read_bytes(), smi, tap)
        # t. at config #5's index (6a's direct table, 6b's 8 ranged slab
        # tables) and its query's key pack
        index.derived.clear()
        k6, s6 = (int(chr1["6a"]["plan"][f]) for f in ("k", "stride"))
        tables["6a seed table"] = _seed_table_t(seed_mode, "6a", index, k6)
        refk = seed_mode.seed_table_rows(index.text, index.sa, k6)[0]
        bbits, shift = _direct_bucket_plan(index, k6)
        tables["6a bucket starts"] = _bucket_t(seed_mode, "6a", k6, bbits,
                                               shift, [(refk, 0, index.n)])
        slab, s, R, bases, _ = sharded._slab_plan(refk, index.n, k6,
                                                  CHR1_SLABS, 3 << 30)
        refk_p, _ = sharded._pad_rows(refk, index.sa, k6, slab * CHR1_SLABS)
        del refk
        tables["6b bucket starts"] = _bucket_t(
            seed_mode, "6b", k6, R.bit_length() - 1, s,
            [(refk_p[i * slab:(i + 1) * slab], int(bases[i]),
              index.n - i * slab) for i in range(CHR1_SLABS)])
        del refk_p
        tables["6a key pack"] = _pack_t(
            seed_mode, "6a", seed_mode.query_to_device(
                sets[1].sequence(0).codes, "cuda")[1], k6, s6)
        _log(f"[tables] {smi}; " + json.dumps(tables, sort_keys=True))
        del index, sets
        dist.destroy_process_group()
        _log("[mesh] " + json.dumps(mesh_runs, sort_keys=True))

    # e. the extension kernel against its plain version on the merged,
    # span-filtered runs of 5d and 6a and on edge triples
    ext_e = {label: _extend_phase(seed_mode, tap, label, args)
             for label, args in replays.items()}
    del replays
    _log("[extend] " + json.dumps(ext_e, sort_keys=True))

    for name, c in checks.items():
        _log(f"[rank] {name}: 4M random queries: kernel {c['big']['ms']:.6f}"
             f" ms ({c['big']['gb_per_s']:.2f} GB/s, bound "
             f"{c['big']['bound_ms']:.6f} ms, up side "
             f"{c['big']['up_bound_ms']:.6f} ms) vs plain "
             f"{c['big']['plain_ms']:.6f} ms; > L2 table: kernel "
             f"{c['hbm']['ms']:.6f} ms ({c['hbm']['gb_per_s']:.2f} GB/s, "
             f"bound {c['hbm']['bound_ms']:.6f} ms, up side "
             f"{c['hbm']['up_bound_ms']:.6f} ms) vs plain "
             f"{c['hbm']['plain_ms']:.6f} ms; {smi}")
    for layout, c in scans.items():
        _log(f"[scan 2s] scan_lanes_{layout}: one 4M chunk {c['ms']:.6f} ms "
             f"vs plain loop {c['plain_ms']:.3f} ms; bound "
             f"{c['bound_ms']:.6f} ms ({c['bound_by']}; whole rows "
             f"{c['whole_row_bound_ms']:.6f} ms), latency estimate "
             f"{c['latency_est_ms']:.6f} ms; {smi}")
    source = "slamem_tpu_torch/kernels/csrc/rank.cu"
    scan_tpu = "slamem_tpu/engine/scan_mode.py:90"
    kernels = []
    # the standalone kernels at the old scan batch shape (32,768 queries);
    # on the main path their device function runs inside the scan kernel
    # of the same layout, whose launches (phases 3k and 3) these are
    for name, c, layout, fn, tpu in (
            ("rank_rows", checks["rank_rows"], "k0", "occ2_warp<K0Layout>",
             "slamem_tpu/kernels/rank.py:87"),
            ("rank_rows_nib", checks["rank_rows_nib"], "nib",
             "occ2_warp<NibLayout>", "slamem_tpu/kernels/rank.py:253")):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu,
            "path": f"scan_lanes_{layout} (device function {fn})",
            "launches": launches[f"scan_lanes_{layout}"],
            "max_abs_err": max(c[k]["max_abs_err"] for k in c),
            "ms": c["shape"]["ms"], "plain_ms": c["shape"]["plain_ms"],
            "bound_ms": c["shape"]["bound_ms"],
            "bound_by": c["shape"]["bound_by"],
            "up_bound_ms": c["shape"]["up_bound_ms"],
            "4m_queries": {k: {f: c[k][f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "up_bound_ms")}
                for k in ("big", "hbm")},
            "library_ms": None})   # no one PyTorch call computes occ
    # the scan kernel on one full 4M chunk (2s); launches: phase 3 / 3k
    for layout, tpu in (("k0", "slamem_tpu/kernels/rank.py:87"),
                        ("nib", "slamem_tpu/kernels/rank.py:253")):
        c = scans[layout]
        kernels.append({
            "name": f"scan_lanes_{layout}", "route": "cuda",
            "source": source, "replaces": f"{tpu} + {scan_tpu}",
            "launches": launches[f"scan_lanes_{layout}"],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "whole_row_bound_ms": c["whole_row_bound_ms"],
            "library_ms": None})   # no PyTorch call runs a backward search
    # the any-width nibble kernel (phase 2w): launches in 2w's main path
    # (rank_nib at 512, 2048, 4096 and 130 words on both indexes), times at
    # 512 words on the 5 Mbp index, every width beside
    c = drop["5 Mbp index 512"]
    kernels.append({
        "name": "rank_rows_nib_any", "route": "cuda", "source": source,
        "replaces": "slamem_tpu/kernels/rank.py:253 (row_words != 128)",
        "path": "rank_nib(index, chars, positions, row_words)",
        "launches": drop["launches"]["rank_rows_nib_any"],
        "max_abs_err": max(v["max_abs_err"] for k, v in drop.items()
                           if isinstance(v, dict) and "max_abs_err" in v),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "up_bound_ms": c["up_bound_ms"],
        "widths": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "up_bound_ms")}
                   for k, v in drop.items() if isinstance(v, dict)
                   and "ms" in v and not k.endswith((" 128", " k0"))},
        "library_ms": None})   # no one PyTorch call computes occ
    # the unpack kernel at the 6a / 5d query's shape (phase u); launches:
    # 5a's two uploads
    c = wire["query"]
    kernels.append({
        "name": "unpack_codes", "route": "cuda",
        "source": "slamem_tpu_torch/kernels/csrc/unpack2.cu",
        "replaces": "slamem_tpu/utils/pack2.py:59",
        "launches": launches["unpack_codes"],
        "max_abs_err": max(w["max_abs_err"] for w in wire.values()),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "library_ms": None})   # no one PyTorch call unpacks a 2-bit plane
    # the extension kernel at 6a's merged runs (phase e); launches: 5a's
    c = ext_e["6a"]
    kernels.append({
        "name": "extend_runs", "route": "cuda",
        "source": "slamem_tpu_torch/kernels/csrc/extend.cu",
        "replaces": "slamem_tpu/engine/seed_mode.py:637 + :555",
        "launches": launches["extend_runs"],
        "max_abs_err": max(e["max_abs_err"] for e in ext_e.values()),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "library_ms": None})   # no PyTorch call extends matches
    # the seed tables' kernels at 6a's shapes (phase t); launches: 5a's
    for name, key, source, tpu, library in (
            ("seed_table", "6a seed table", "seedkeys.cu",
             "slamem_tpu/engine/seed_mode.py:308 + :64 + :485", False),
            ("packed_key_words", "6a key pack", "seedkeys.cu",
             "slamem_tpu/engine/seed_mode.py:64", False),
            ("bucket_starts", "6a bucket starts", "buckets.cu",
             "slamem_tpu/engine/seed_mode.py:355 + "
             "slamem_tpu/dist/sharded.py:331", True)):
        c = tables[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"slamem_tpu_torch/kernels/csrc/{source}",
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": max(t["max_abs_err"] for lb, t in tables.items()
                               if lb.endswith(key[3:])),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            # torch.searchsorted of the prefixes over every bucket; no
            # PyTorch call packs K-mers
            "library_ms": c["library_ms"] if library else None})
    # the index build's occ checkpoints at chr1's size (phase o); launches:
    # 5a's (one a build, as in every CLI phase)
    kernels.append({
        "name": "occ_checkpoints", "route": "cuda",
        "source": "slamem_tpu_torch/kernels/csrc/occ.cu",
        "replaces": "none (XLA's cumsum in slamem_tpu/index/build.py"
                    "::_finish_index)",
        "launches": launches["occ_checkpoints"],
        "max_abs_err": occ_o["max_abs_err"], "ms": occ_o["ms"],
        "plain_ms": occ_o["plain_ms"], "bound_ms": occ_o["bound_ms"],
        "bound_by": occ_o["bound_by"],
        # torch.cumsum of the block counts along the contiguous dimension
        "library_ms": occ_o["library_ms"]})
    # the suffix sort's window keys at chr1's size (phase k); launches:
    # 5a's (one a build, as in every CLI phase)
    kernels.append({
        "name": "sa_keys", "route": "cuda",
        "source": "slamem_tpu_torch/kernels/csrc/sakeys.cu",
        "replaces": "none (the first prefix-doubling rounds from "
                    "initial_ranks in slamem_tpu/index/build.py"
                    "::suffix_array)",
        "launches": launches["sa_keys"],
        "max_abs_err": keys_k["max_abs_err"], "ms": keys_k["ms"],
        "plain_ms": keys_k["plain_ms"], "bound_ms": keys_k["bound_ms"],
        "bound_by": keys_k["bound_by"],
        "library_ms": None})   # no one PyTorch call packs the windows
    # the scan engine's LCP array at chr1's 250,000,001 rows (phase 6s);
    # launches: 6s's CLI call (1, and 1 more where pairs are long)
    k = chr1["6s"]["lcp_kernel"]
    kernels.append({
        "name": "lcp_adjacent", "route": "cuda",
        "source": "slamem_tpu_torch/kernels/csrc/lcp.cu",
        "replaces": "none (the XLA doubling rounds and descent of "
                    "slamem_tpu/index/lcp.py::lcp_adjacent)",
        "launches": chr1["6s"]["lcp_launches"],
        "long_pairs": k["long_pairs"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "sector_bound_ms": k["sector_bound_ms"], "sectors": k["sectors"],
        "library_ms": None})   # no one PyTorch call compares suffixes
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(scan_chr1_main(sys.argv[1:]) if "--scan-chr1" in
                     sys.argv else run())
