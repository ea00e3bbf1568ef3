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
     must be identical;
  5. the default engine (seed: K-mer frontend, sparse seeding, endpoint
     extension), through the CLI without ``-engine``, on ``-device cuda``,
     at the bench's sizes, each listing holding exactly the JAX package's
     count (BENCH_DETAIL.json):
     5a. the headline pair at ``-l 20``: 59,101 MEMs, exact and maximal,
         byte-identical to phase 3's scan listing;
     5b. the same pair with ``-mam -l 20``: 59,083;
     5c. ``strain_pair(40_000_000, ...)`` (same seed and rates) at
         ``-l 50``: 286,645, exact and maximal (the chr21-scale stand-in);
     5d. the headline reference against 10 strains
         ``mutate(ref, 0.01 + 0.001 j, 0.001, seed=100 + j)`` as one
         multi-FASTA query at ``-l 30``: 478,358;
     5e. phase 4's input through ``-b``, ``-b -mum`` and ``-b -mam``: GPU
         bytes == CPU bytes.
     5a-5d print the plan (K, stride, frontend, rounds), index build and
     query seconds, each stage's device-synchronised seconds (the CLI's
     ``-v`` line) and peak device memory;
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
     6c. phase 4's input through ``-shard -slabs 3 -b``, ``-b -mum`` and
         ``-b -mam``: GPU bytes == CPU bytes == the default call's bytes
         (5e), and ``-shard -b`` alone == the default call.
     6a and 6b print the plan (K, stride, slabs, shift, probes, R, rounds,
     pairs), index build and query seconds, stage seconds, peak device
     memory and the card's name and power limit.
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


def _seed_phase(cli_main, label: str, flags: list[str], want: int, rp: str,
                qp: str, out: str) -> dict:
    """One default-engine CLI run on the card: count, plan, stage times,
    peak device memory. Raises if the count is not ``want``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stderr = _cli(cli_main, [*flags, "-device", "cuda", "-v", "-o", out, rp,
                             qp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = _verbose_stats(stderr)
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
         f"{wall:.3f} s; peak device memory {st['peak_gib']:.3f} GiB")
    if st["matches"] != want:
        raise AssertionError(f"seed {label}: {st['matches']} matches, "
                             f"expected {want}")
    return st


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
                       ("ref.fa", "qry.fa", "scan.txt"))
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
        stats = _verbose_stats(stderr)
        matches = _listing_matches(out)
        _log(f"[slice] 5 Mbp scan -l {HEADLINE_L}: {len(matches)} matches; "
             f"index build {stats['build_s']} s, query {stats['query_s']} s "
             f"({stats['mbp_per_s']} Mbp/s), CLI wall {wall:.3f} s; rank "
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

        # 5a-5d. the default engine at the bench's sizes
        seed_out = os.path.join(tmp, "seed.txt")
        seed = {"5a": _seed_phase(cli_main, "5a", ["-l", str(HEADLINE_L)],
                                  HEADLINE_MATCHES, rp, qp, seed_out)}
        if Path(seed_out).read_bytes() != Path(out).read_bytes():
            raise AssertionError("5a: seed listing != phase 3's scan listing")
        _check_maximal(ref, qry, _listing_matches(seed_out))
        _log("[seed 5a] listing == scan listing; every match exact and "
             "maximal")
        seed["5b"] = _seed_phase(cli_main, "5b", ["-mam", "-l",
                                                  str(HEADLINE_L)],
                                 MAM_MATCHES, rp, qp, seed_out)
        strains = [Sequence(f"strain{j}", synth.mutate(
            ref, 0.01 + 0.001 * j, 0.001, seed=100 + j))
            for j in range(STRAINS)]
        qp3 = os.path.join(tmp, "strains.fa")
        write_fasta(qp3, strains)
        del strains
        seed["5d"] = _seed_phase(cli_main, "5d", ["-l", str(STRAINS_L)],
                                 STRAINS_MATCHES, rp, qp3, seed_out)
        ref, qry = synth.strain_pair(CHR21["n"], seed=CHR21["seed"],
                                     sub_rate=CHR21["sub_rate"],
                                     indel_rate=CHR21["indel_rate"])
        write_fasta(rp, [Sequence("ref", ref)])
        write_fasta(qp, [Sequence("qry", qry)])
        seed["5c"] = _seed_phase(cli_main, "5c", ["-l", str(CHR21_L)],
                                 CHR21_MATCHES, rp, qp, seed_out)
        _check_maximal(ref, qry, _listing_matches(seed_out))
        _log("[seed 5c] every match exact and maximal")
        torch.cuda.synchronize()
        _log("[seed] " + json.dumps(seed, sort_keys=True))

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
        chr1 = {"6a": _seed_phase(cli_main, "6a", ["-l", str(CHR1_L)],
                                  CHR1_MATCHES, rp, qp, seed_out)}
        _check_maximal(ref, qry, _listing_matches(seed_out))
        _log("[chr1 6a] every match exact and maximal")
        shard_out = os.path.join(tmp, "shard.txt")
        chr1["6b"] = _seed_phase(
            cli_main, "6b", ["-shard", "-slabs", str(CHR1_SLABS), "-l",
                             str(CHR1_L)], CHR1_MATCHES, rp, qp, shard_out)
        if Path(shard_out).read_bytes() != Path(seed_out).read_bytes():
            raise AssertionError("6b: -shard -slabs listing != 6a's")
        _log(f"[chr1 6b] {CHR1_SLABS}-slab listing == replicated listing")
        _log("[chr1] " + json.dumps(chr1, sort_keys=True))

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
