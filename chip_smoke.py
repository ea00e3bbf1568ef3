"""Chip check of the PyTorch port (``slamem_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases, each of which raises on failure (exit status non-zero):
  1. build the rank kernel (csrc/rank.cu, nvcc, sm_90a) from the checkout;
  2. hold the kernel against its plain PyTorch version on the 5 Mbp headline
     reference's table: >= 4M random (c, j) queries plus the edge positions,
     and the scan engine's batch shape; exact integer equality; times both;
  3. the scan slice end to end through the CLI, ``-engine scan -l 20
     -device cuda``, on the bench's headline pair
     (strain_pair(5_000_000, seed=20260816, sub_rate=0.015,
     indel_rate=0.0015)): the listing must hold exactly 59,101 MEMs (the
     count the JAX package records in BENCH_DETAIL.json), every one an exact
     maximal match, and the run must have launched the kernel;
  4. a ~200 kbp multi-FASTA pair with N runs through ``-b``, ``-b -mum`` and
     ``-b -mam``: the listing bytes on ``-device cuda`` and ``-device cpu``
     must be identical.
Prints the card and its power limit (nvidia-smi), a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. Imports no JAX.
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
from pathlib import Path

HEADLINE = dict(n=5_000_000, seed=20260816, sub_rate=0.015,
                indel_rate=0.0015)
HEADLINE_L = 20
HEADLINE_MATCHES = 59_101        # BENCH_DETAIL.json headline_5mbp_l20.matches
RANDOM_QUERIES = 1 << 22         # 4,194,304 random occ queries
ROW_BYTES = 512                  # one interleaved table row per query


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


def _kernel_vs_plain(rank, rows, chars, positions, label: str) -> dict:
    """Exact check of rank_rows against rank_rows_plain, then times: the
    raw kernel launch, the wrapper (with its argument checks) and plain."""
    import torch

    got = rank.rank_rows(rows, chars, positions)
    want = rank.rank_rows_plain(rows, chars, positions)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel != plain (max abs err {err})")
    fn = rank.load_kernel().fn
    out = torch.empty_like(positions)
    nq = positions.numel()
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        if fn(rows.data_ptr(), chars.data_ptr(), positions.data_ptr(),
              out.data_ptr(), nq, stream):
            raise RuntimeError("rank kernel launch failed")

    ms = _cuda_ms(raw, 50)
    wrapper_ms = _cuda_ms(lambda: rank.rank_rows(rows, chars, positions), 20)
    plain_ms = _cuda_ms(lambda: rank.rank_rows_plain(rows, chars, positions),
                        5)
    gbps = ROW_BYTES * nq / (ms * 1e-3) / 1e9
    _log(f"[rank] {label}: {nq} queries, table {rows.numel() * 4} B; "
         f"kernel {ms:.6f} ms ({gbps:.2f} GB/s at 512 B/query), "
         f"wrapper {wrapper_ms:.6f} ms, plain {plain_ms:.6f} ms; exact")
    return {"queries": nq, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "gb_per_s": gbps, "max_abs_err": err}


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

    import numpy as np

    from slamem_tpu_torch.cli.main import main as cli_main
    from slamem_tpu_torch.engine import scan_mode
    from slamem_tpu_torch.index.build import build_index
    from slamem_tpu_torch.io.fasta import Sequence, write_fasta
    from slamem_tpu_torch.kernels import rank
    from slamem_tpu_torch.utils import synth

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"[device] {kind}; torch {torch.__version__} cuda "
         f"{torch.version.cuda}")
    _log(smi)

    # 1. build
    t0 = time.perf_counter()
    kernel = rank.load_kernel()
    _log(f"[build] rank kernel {kernel.path.name} in "
         f"{time.perf_counter() - t0:.3f} s")
    for line in kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            _log(f"[build] {line.strip()}")

    # 2. kernel vs plain on the headline reference's table
    ref, qry = synth.strain_pair(HEADLINE["n"], seed=HEADLINE["seed"],
                                 sub_rate=HEADLINE["sub_rate"],
                                 indel_rate=HEADLINE["indel_rate"])
    index = build_index(ref, device="cuda")
    rows = rank.interleaved_rows(index)
    torch.cuda.synchronize()
    n = index.n
    gen = torch.Generator(device="cuda").manual_seed(HEADLINE["seed"])
    edges = torch.tensor([0, 1, 495, 496, 497, n - 1, n], dtype=torch.int32,
                         device="cuda").repeat_interleave(4)
    edge_c = torch.arange(4, dtype=torch.int32, device="cuda").repeat(7)
    positions = torch.cat([torch.randint(0, n + 1, (RANDOM_QUERIES,),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32), edges])
    chars = torch.cat([torch.randint(0, 4, (RANDOM_QUERIES,), generator=gen,
                                     device="cuda", dtype=torch.int32),
                       edge_c])
    big = _kernel_vs_plain(rank, rows, chars, positions,
                           "random + edges, 5 Mbp table")
    # the scan engine's batch: 2 occ queries per lane, one lane per 256
    # query positions of a chunk of at most _SCAN_CHUNK positions
    lanes = -(-min(len(qry), scan_mode._SCAN_CHUNK) // 256)
    slice_shape = _kernel_vs_plain(rank, rows, chars[:2 * lanes].contiguous(),
                                   positions[:2 * lanes].contiguous(),
                                   "scan batch shape, 5 Mbp table")
    bwt_big = torch.randint(0, 4, (200_000_000,), generator=gen,
                            device="cuda", dtype=torch.uint8)
    rows_big = rank._build_rows(bwt_big)
    pos_big = torch.randint(0, bwt_big.numel() + 1, (RANDOM_QUERIES,),
                            generator=gen, device="cuda", dtype=torch.int32)
    hbm = _kernel_vs_plain(rank, rows_big, chars[:RANDOM_QUERIES].contiguous(),
                           pos_big, "random, 200 M-symbol table (> L2)")
    del bwt_big, rows_big, pos_big, index, rows
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        # 3. the scan slice end to end at the headline input
        rp, qp, out = (os.path.join(tmp, f) for f in
                       ("ref.fa", "qry.fa", "out.txt"))
        write_fasta(rp, [Sequence("ref", ref)])
        write_fasta(qp, [Sequence("qry", qry)])
        torch.cuda.reset_peak_memory_stats()
        rank.rank_rows.launches = 0
        t0 = time.perf_counter()
        stderr = _cli(cli_main, ["-engine", "scan", "-l", str(HEADLINE_L),
                                 "-device", "cuda", "-v", "-o", out, rp, qp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rank.rank_rows.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        stats = re.search(r"index build: ([0-9.]+)s; query: ([0-9.]+) Mbp in "
                          r"([0-9.]+)s \(([0-9.]+) Mbp/s\)", stderr)
        if stats is None:
            raise AssertionError(f"no statistics line in {stderr!r}")
        matches = _listing_matches(out)
        _log(f"[slice] 5 Mbp scan -l {HEADLINE_L}: {len(matches)} matches; "
             f"index build {stats.group(1)} s, query {stats.group(3)} s "
             f"({stats.group(4)} Mbp/s), CLI wall {wall:.3f} s; rank "
             f"kernel launches {launches}; peak device memory "
             f"{peak_gib:.3f} GiB")
        if len(matches) != HEADLINE_MATCHES:
            raise AssertionError(f"{len(matches)} matches, expected "
                                 f"{HEADLINE_MATCHES}")
        if launches <= 0:
            raise AssertionError("the scan slice never launched the kernel")
        _check_maximal(ref, qry, matches)
        _log("[slice] every match exact and maximal")

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
        for mode in ([], ["-mum"], ["-mam"]):
            texts = {}
            for dev in ("cuda", "cpu"):
                o = os.path.join(tmp, f"out_{dev}.txt")
                _cli(cli_main, ["-engine", "scan", "-b", "-l", "20", *mode,
                                "-device", dev, "-o", o, rp2, qp2])
                texts[dev] = Path(o).read_bytes()
            nm = len(_listing_matches(os.path.join(tmp, "out_cpu.txt")))
            if texts["cuda"] != texts["cpu"] or nm == 0:
                raise AssertionError(f"-b {' '.join(mode)}: GPU and CPU "
                                     f"listings differ or are empty ({nm})")
            _log(f"[bytes] -b {' '.join(mode) or '-mem'}: {nm} matches, "
                 f"{len(texts['cpu'])} bytes, GPU == CPU")
        torch.cuda.synchronize()

    _log(f"[rank] 4M random queries: kernel {big['ms']:.6f} ms "
         f"({big['gb_per_s']:.2f} GB/s) vs plain {big['plain_ms']:.6f} ms; "
         f"> L2 table: kernel {hbm['ms']:.6f} ms ({hbm['gb_per_s']:.2f} GB/s)"
         f" vs plain {hbm['plain_ms']:.6f} ms")
    print(json.dumps({"kernels": [{
        "name": "rank_rows",
        "route": "cuda",
        "source": "slamem_tpu_torch/kernels/csrc/rank.cu",
        "replaces": "slamem_tpu/kernels/rank.py:87",
        "launches": launches,
        "max_abs_err": max(big["max_abs_err"], slice_shape["max_abs_err"],
                           hbm["max_abs_err"]),
        "ms": slice_shape["ms"],
        "plain_ms": slice_shape["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
