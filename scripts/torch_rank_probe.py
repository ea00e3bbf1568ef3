#!/usr/bin/env python3
"""A/B probe of the standalone rank kernels
(``slamem_tpu_torch/kernels/csrc/rank.cu``: ``slamem_rank_rows`` (K0),
``slamem_rank_rows_nib`` (128-word nibble rows) and
``slamem_rank_rows_nib_any`` (nibble rows of any other width)) on one card.

    python3 scripts/torch_rank_probe.py --old DIR [--variant LABEL=DIR ...]

Builds the rank library of this checkout, of the checkout DIR (its
``slamem_tpu_torch/``; an older design, e.g. a ``git archive`` of the
parent commit in an ignored directory) and of each variant, all in one
process on one card. A tree whose entry points do not take the table's row
count (before the nearer-counter design) is called without it. Inputs are
those of ``chip_smoke.py``'s phases 2 and 2w, made from ``--seed`` in the
same order: the 5 Mbp headline index and its 4,194,304 random (c, j) (+
phase 2's row edges: K0 and the 128-word nibble kernel; + 2w's edges of
every width: the any-width kernel at 130, 512, 2048 and 4096 words), the
first 32,768 of those (the old scan batch shape), and 4,194,304 random
queries over an index of a random 200 M-symbol BWT (tables past L2). At
each shape every build's kernel == the plain version, exact, and every
build is timed by CUDA events in turns (old, variants, this checkout,
then the reverse; the mean of the two), beside the nearer-side and up-side
bounds of ``chip_smoke._sector_bound``. Prints ``[probe]`` lines and a
last JSON line; needs a CUDA card and nvcc (CUDA_HOME or
/usr/local/cuda).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from slamem_tpu_torch.index.build import build_index  # noqa: E402
from slamem_tpu_torch.kernels import BUILD_DIR, build_nvcc, rank  # noqa: E402
from slamem_tpu_torch.utils import synth  # noqa: E402

WIDTHS = chip_smoke.NIB_WIDTHS[1:]   # the any-width kernel's: not 128


def _log(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


class _Build:
    """One tree's rank library, built, with its standalone entry points."""

    def __init__(self, label: str, root: Path) -> None:
        self.label = label
        text = (root / "slamem_tpu_torch" / "kernels" / "csrc" /
                "rank.cu").read_text()
        work = BUILD_DIR / "rank_probe" / label
        work.mkdir(parents=True, exist_ok=True)
        src = work / "rank.cu"
        src.write_text(text)
        path, log = build_nvcc(src, f"rank_probe_{label}")
        self.log = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "rank_rows" in ln]
        # the row count (nrows) follows nq in the nearer-counter entries
        self.nrows = bool(re.search(r"slamem_rank_rows\([^)]*nrows", text))
        lib = ctypes.CDLL(str(path))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        rows_arg = [i32] if self.nrows else []
        self.fns = {}
        for key, name, width in (("k0", "slamem_rank_rows", []),
                                 ("nib", "slamem_rank_rows_nib", []),
                                 ("any", "slamem_rank_rows_nib_any", [i32])):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * 4 + [i64] + rows_arg + width + [vp]
            fn.restype = ctypes.c_int
            self.fns[key] = fn

    def launcher(self, key: str, rows, chars, positions, out):
        fn = self.fns[key]
        args = [rows.data_ptr(), chars.data_ptr(), positions.data_ptr(),
                out.data_ptr(), positions.numel()]
        if self.nrows:
            args.append(int(rows.shape[0]))
        if key == "any":
            args.append(int(rows.shape[1]))
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            if fn(*args, stream):
                raise RuntimeError(f"{self.label} {key}: launch failed")
        return run


def _shape(label: str, builds: list, key: str, rows, chars, positions,
           reps: int) -> dict:
    """Every build's kernel == plain on one shape, then their times in
    turns and the bounds."""
    plain = rank.rank_rows_plain if key == "k0" else rank.rank_rows_nib_plain
    want = plain(rows, chars, positions)
    runs = {}
    for b in builds:
        out = torch.full_like(positions, -1)
        run = b.launcher(key, rows, chars, positions, out)
        run()
        chip_smoke._exact(f"probe {label} {b.label}", (out,), (want,))
        runs[b.label] = run
    times = chip_smoke._turns(runs, reps)
    spw, opw = (4, 16) if key == "k0" else (8, 8)
    near = chip_smoke._sector_bound(rows, chars, positions, spw, opw)
    up = chip_smoke._sector_bound(rows, chars, positions, spw, opw,
                                  nearer=False)
    _log(f"{label}: {positions.numel()} queries, exact; " + ", ".join(
        f"{k} {v:.6f} ms" for k, v in times.items()) +
        f"; bound {near['bound_ms']:.6f} ms ({near['bound_by']}, nearer "
        f"side), up side {up['bound_ms']:.6f} ms ({up['bound_by']})")
    return {"queries": positions.numel(), "ms": times,
            "bound_ms": near["bound_ms"], "bound_by": near["bound_by"],
            "up_bound_ms": up["bound_ms"], "up_bound_by": up["bound_by"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="a checkout of the port with the older design")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="LABEL=DIR", help="another checkout to time")
    ap.add_argument("--seed", type=int, default=chip_smoke.HEADLINE["seed"])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    trees = {"old": args.old.resolve()}
    for v in args.variant:
        name, _, path = v.partition("=")
        trees[name] = Path(path).resolve()
    trees["new"] = REPO
    with ThreadPoolExecutor(len(trees)) as ex:
        builds = list(ex.map(lambda kv: _Build(*kv), trees.items()))
    for b in builds:
        _log(f"{b.label}: nrows argument {b.nrows}; " + " | ".join(b.log))
    # phase 2's inputs, in chip_smoke's order
    hl = chip_smoke.HEADLINE
    ref, _ = synth.strain_pair(hl["n"], seed=args.seed,
                               sub_rate=hl["sub_rate"],
                               indel_rate=hl["indel_rate"])
    index = build_index(ref, device="cuda")
    n = index.n
    nq = chip_smoke.RANDOM_QUERIES
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rand_pos = torch.randint(0, n + 1, (nq,), generator=gen, device="cuda",
                             dtype=torch.int32)
    rand_c = torch.randint(0, 4, (nq,), generator=gen, device="cuda",
                           dtype=torch.int32)
    bwt_big = torch.randint(0, 4, (200_000_000,), generator=gen,
                            device="cuda", dtype=torch.uint8)
    pos_big = torch.randint(0, bwt_big.numel() + 1, (nq,), generator=gen,
                            device="cuda", dtype=torch.int32)
    four = torch.arange(4, dtype=torch.int32, device="cuda")
    out = {"card": smi}
    # phase 2: K0 and the 128-word nibble kernel
    for key, rows, build, per in (
            ("k0", rank.interleaved_rows(index), rank._build_rows,
             rank.SYMS_PER_ROW),
            ("nib", rank.nibble_rows(index), rank._build_rows_nib,
             rank.NIB_PER_ROW)):
        span = rows.shape[0] * per
        edge = torch.tensor(sorted({0, 1, per - 1, per, per + 1, 2 * per - 1,
                                    2 * per, n - 1, n, span - 1}),
                            dtype=torch.int32, device="cuda")
        pos = torch.cat([rand_pos, edge.repeat_interleave(4)])
        chars = torch.cat([rand_c, four.repeat(edge.numel())])
        out[f"2 {key} 4M"] = _shape(f"2 {key} 5 Mbp, 4M + edges", builds,
                                    key, rows, chars, pos, args.reps)
        out[f"2 {key} 32768"] = _shape(
            f"2 {key} 5 Mbp, 32,768", builds, key, rows,
            chars[:32768].contiguous(), pos[:32768].contiguous(), args.reps)
        big = build(bwt_big)
        out[f"2 {key} > L2"] = _shape(f"2 {key} 200 M-symbol, 4M", builds,
                                      key, big, rand_c, pos_big, args.reps)
        del big, rows
        torch.cuda.empty_cache()
    # phase 2w: the any-width kernel on 2w's queries
    edges = {0, 1, n - 1, n}
    for per in [rank.SYMS_PER_ROW] + [(w - rank.CNT_WORDS) * 8
                                      for w in chip_smoke.NIB_WIDTHS]:
        for b in range(n // per + 1):
            edges.update(b * per + d for d in (-1, 0, 1, per // 2))
    edge = torch.tensor(sorted(e for e in edges if 0 <= e <= n),
                        dtype=torch.int32, device="cuda")
    chars = torch.cat([rand_c, four.repeat(edge.numel())])
    pos = torch.cat([rand_pos, edge.repeat_interleave(4)])
    for key, rows in (("k0", rank.interleaved_rows(index)),
                      ("nib", rank.nibble_rows(index))):
        out[f"2w {key} L2"] = _shape(f"2w {key} 5 Mbp", builds, key, rows,
                                     chars, pos, args.reps)
    for w in WIDTHS:
        out[f"2w {w} L2"] = _shape(f"2w nib {w} words, 5 Mbp", builds, "any",
                                   rank._build_rows_nib(index.bwt, w), chars,
                                   pos, args.reps)
        out[f"2w {w} > L2"] = _shape(
            f"2w nib {w} words, 200 M-symbol", builds, "any",
            rank._build_rows_nib(bwt_big, w), rand_c, pos_big, args.reps)
        torch.cuda.empty_cache()
    _log(smi)
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
