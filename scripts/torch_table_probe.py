#!/usr/bin/env python3
"""A/B probe of the seed tables' two CUDA kernels on one card.

    python3 scripts/torch_table_probe.py [--old DIR] [--n 250000000]

Times the seed-table kernel (``slamem_tpu_torch/kernels/csrc/seedkeys.cu``)
and the bucket-start kernel (``csrc/buckets.cu``) of this checkout and,
with ``--old``, those of another checkout of the port (DIR holds its
``slamem_tpu_torch/``; either kernel ABI: the one-launch
``slamem_seed_table`` or the plane pass + gather), in one process on one
card, in turns old, new, new, old. Each bucket kernel is also built with
its stores to the table removed (a copy of its source whose stores only
keep their values live), which splits its time into loads + search and
stores, and is timed beside a streaming yardstick of its bytes (a sum over
the keys, a fill of the table). Inputs are made from ``--seed``: a random
text of ``--n`` codes ending in a separator (config #5's reference size by
default) and a 5 Mbp one, their indexes built on the card by the port;
the shapes are config #5's (K 14: the direct table of 2^28 + 1 entries,
and the 8 ranged slab tables of ``-shard -slabs 8``) and the 5 Mbp pair's
(K 13, 2^26 + 1). Every kernel's output is checked equal to its plain
version first. Prints one ``[probe]`` line per measurement and a last
JSON line; needs a CUDA card and nvcc (CUDA_HOME or /usr/local/cuda).
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

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from slamem_tpu_torch.dist import sharded  # noqa: E402
from slamem_tpu_torch.engine import seed_mode  # noqa: E402
from slamem_tpu_torch.index.build import build_index  # noqa: E402
from slamem_tpu_torch.kernels import BUILD_DIR, build_nvcc  # noqa: E402

# the stores of each bucket kernel design (PR 10's, then these), and
# what replaces them in its copy without stores (the value kept live,
# nothing written)
_KEEP = 'asm volatile("" :: "r"({}));'
_STORES = {
    "starts[e] = value;": _KEEP.format("value"),
    "if (e <= hi) starts[e] = static_cast<int32_t>(w0 + at);":
        "if (e <= hi) " + _KEEP.format("static_cast<int32_t>(w0 + at)"),
    "__stcs(starts + e0 + j, value);": _KEEP.format("value"),
    "__stcs(reinterpret_cast<int4*>(starts + e0),\n"
    "                   make_int4(value, value, value, value));":
        _KEEP.format("value"),
    "__stcs(starts + e0 + j, row[j]);": _KEEP.format("row[j]"),
    "__stcs(reinterpret_cast<int4*>(starts + e0), v);":
        'asm volatile("" :: "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));',
}


def _log(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


def _without_stores(src: Path, out: Path) -> Path:
    """A copy of a bucket kernel's source with its table stores removed;
    raises if a store to the table is left."""
    text = src.read_text()
    for store, keep in _STORES.items():
        text = text.replace(store, keep)
    store = re.compile(r"starts\s*\[[^\]]*\]\s*=[^=]|__stcs\(")
    left = [line for line in text.splitlines()
            if store.search(line) and not line.lstrip().startswith("//")]
    if left or text == src.read_text():
        raise RuntimeError(f"{src}: table stores left: {left}")
    out.write_text(text)
    return out


class _Lib:
    """One build of seedkeys.cu + buckets.cu (+ buckets without stores)."""

    def __init__(self, label: str, csrc: Path) -> None:
        self.label = label
        work = BUILD_DIR / "probe" / label
        work.mkdir(parents=True, exist_ok=True)
        nostore = _without_stores(csrc / "buckets.cu",
                                  work / "buckets_nostore.cu")
        jobs = {"seed": (csrc / "seedkeys.cu", f"probe_{label}_seed"),
                "buckets": (csrc / "buckets.cu", f"probe_{label}_buckets"),
                "nostore": (nostore, f"probe_{label}_nostore")}
        with ThreadPoolExecutor(len(jobs)) as ex:
            built = {k: ex.submit(build_nvcc, *v) for k, v in jobs.items()}
            paths = {k: f.result()[0] for k, f in built.items()}
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib = ctypes.CDLL(str(paths["seed"]))
        if hasattr(lib, "slamem_seed_table"):        # one launch
            self.seed = {"table": lib.slamem_seed_table}
            self.seed["table"].argtypes = [vp, i64, vp, i64, i32, vp, vp, vp]
        else:                                        # plane + gather
            self.seed = {"plane": lib.slamem_seed_plane,
                         "gather": lib.slamem_seed_gather}
            self.seed["plane"].argtypes = [vp, i64, vp, vp]
            self.seed["gather"].argtypes = [vp, i64, vp, vp, i64, i32, vp,
                                            vp, vp]
        for fn in self.seed.values():
            fn.restype = i32
        self.starts = {}
        for kind in ("buckets", "nostore"):
            fn = ctypes.CDLL(str(paths[kind])).slamem_bucket_starts
            fn.argtypes = [vp, i64, i64, i32, i64, i32, i64, vp, vp]
            fn.restype = i32
            self.starts[kind] = fn

    def seed_table(self, text, sa, k):
        """Returns a launcher of the seed table into fresh outputs, its
        parts' launchers (the plane pass and the gather, where there are
        two) and the outputs."""
        n, rows = text.numel(), sa.numel()
        refk = torch.empty(rows, dtype=torch.int64, device=sa.device)
        aug = torch.empty_like(sa)
        stream = torch.cuda.current_stream().cuda_stream
        fns = self.seed
        parts = {}
        if "table" in fns:
            def run():
                if fns["table"](text.data_ptr(), n, sa.data_ptr(), rows, k,
                                refk.data_ptr(), aug.data_ptr(), stream):
                    raise RuntimeError("seed table launch failed")
        else:
            plane = torch.empty(-(-n // 31) + 1, dtype=torch.int64,
                                device=sa.device)

            def plane_pass():
                if fns["plane"](text.data_ptr(), n, plane.data_ptr(),
                                stream):
                    raise RuntimeError("seed plane launch failed")

            def gather():
                if fns["gather"](text.data_ptr(), n, plane.data_ptr(),
                                 sa.data_ptr(), rows, k, refk.data_ptr(),
                                 aug.data_ptr(), stream):
                    raise RuntimeError("seed gather launch failed")

            def run():
                plane_pass()
                gather()
            parts = {"plane": plane_pass, "gather": gather}
        return run, parts, (refk, aug)

    def bucket(self, kind, tables, k, bbits, shift):
        """A launcher of the bucket kernel (or its copy without stores)
        over tables [(rows, base, real, out), ...]."""
        fn = self.starts[kind]
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            for rows, base, real, out in tables:
                if fn(rows.data_ptr(), rows.numel(), real, k, base, shift,
                      1 << bbits, out.data_ptr(), stream):
                    raise RuntimeError("bucket start launch failed")
        return run


def _index(n: int, seed: int):
    """The port's index of n - 1 random codes (build_index appends the
    separator that ends the text)."""
    codes = np.random.default_rng(seed).integers(0, 4, n - 1, dtype=np.uint8)
    return build_index(codes, device="cuda")


def _direct_plan(n: int, k: int) -> tuple[int, int]:
    word0_bits = 2 * min(k, 16)
    if word0_bits <= 28 and (1 << word0_bits) <= max(64 * n, 1 << 22):
        return word0_bits, 0
    return min(word0_bits, 24), word0_bits - min(word0_bits, 24)


def _seed_tables(libs, label, index, k, reps) -> tuple[dict, object]:
    text, sa = index.text, index.sa
    want = seed_mode.seed_table_rows_plain(text, sa, k)
    runs, res = {}, {}
    for lib in libs:
        run, parts, out = lib.seed_table(text, sa, k)
        run()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(out, want)):
            raise AssertionError(f"{label} {lib.label} seed table != plain")
        runs[lib.label] = run
        for part, fn in parts.items():
            runs[f"{lib.label} {part}"] = fn
    refk = want[0]
    del want
    res = chip_smoke._turns(runs, reps)
    rows = sa.numel()
    res["bound_ms"] = (16 * rows + text.numel()) / 3.35e12 * 1e3
    _log(f"{label} seed table, {rows} rows, K {k}: " + ", ".join(
        f"{name} {ms:.6f} ms" for name, ms in res.items()))
    return res, refk


def _buckets(libs, label, slabs, k, bbits, shift, reps) -> dict:
    nb = 1 << bbits
    want = [seed_mode.bucket_starts_plain(rows, k, bbits, shift, base, real)
            for rows, base, real in slabs]
    runs = {}
    for lib in libs:
        for kind in ("buckets", "nostore"):
            outs = [torch.full((nb + 1,), -1, dtype=torch.int32,
                               device="cuda") for _ in slabs]
            tables = [(r, b, m, o) for (r, b, m), o in zip(slabs, outs)]
            run = lib.bucket(kind, tables, k, bbits, shift)
            run()
            torch.cuda.synchronize()
            if kind == "buckets" and not all(
                    torch.equal(o, w) for o, w in zip(outs, want)):
                raise AssertionError(f"{label} {lib.label} buckets != plain")
            runs[f"{lib.label}" + ("" if kind == "buckets"
                                   else " without stores")] = run
    outs = [torch.empty(nb + 1, dtype=torch.int32, device="cuda")
            for _ in slabs]

    def yardstick():
        for (rows, _, real), out in zip(slabs, outs):
            rows[:max(0, min(rows.numel(), real))].sum()
            out.fill_(0)
    runs["yardstick"] = yardstick
    res = chip_smoke._turns(runs, reps)
    real_rows = sum(min(r.numel(), max(m, 0)) for r, _, m in slabs)
    res["bound_ms"] = ((8 * real_rows + 4 * len(slabs) * (nb + 1))
                       / 3.35e12 * 1e3)
    _log(f"{label} bucket starts, {len(slabs)} x {nb + 1} entries over "
         f"{real_rows} rows: " + ", ".join(
             f"{name} {ms:.6f} ms" for name, ms in res.items()))
    return res


def _sweep(libs, sizes, k, reps) -> dict:
    """The seed table over random texts of each size (millions of codes)
    with a random permutation for the SA (the SA's access pattern): ns a
    row of each design, and of the gather alone where there is one (the
    plane is about a quarter of the text)."""
    out = {}
    for mcodes in sizes:
        n = int(mcodes * 1e6)
        gen = torch.Generator(device="cuda").manual_seed(n)
        text = torch.randint(0, 4, (n,), dtype=torch.uint8, device="cuda",
                             generator=gen)
        sa = torch.randperm(n, device="cuda", generator=gen).to(torch.int32)
        runs = {}
        for lib in libs:
            run, parts, _ = lib.seed_table(text, sa, k)
            runs[lib.label] = run
            if "gather" in parts:
                runs[lib.label + " gather"] = parts["gather"]
        res = chip_smoke._turns(runs, reps)
        out[f"{mcodes}M"] = {name: ms * 1e6 / n for name, ms in res.items()}
        _log(f"sweep {mcodes}M codes (plane {n / 4e6:.1f} MB), K {k}, ns a "
             "row: " + ", ".join(f"{name} {v:.4f}"
                                  for name, v in out[f"{mcodes}M"].items()))
        del text, sa, runs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="another checkout of the port")
    ap.add_argument("--n", type=int, default=250_000_000)
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", type=float, nargs="*", default=(),
                    help="also time the seed table on random texts of these "
                         "sizes, in millions of codes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    trees = {"new": REPO}
    if args.old is not None:
        trees = {"old": args.old.resolve(), "new": REPO}
    with ThreadPoolExecutor(len(trees)) as ex:
        libs = list(ex.map(
            lambda kv: _Lib(kv[0], kv[1] / "slamem_tpu_torch" / "kernels"
                            / "csrc"), trees.items()))
    out = {"card": smi}
    if args.sweep:
        out["sweep"] = _sweep(libs, args.sweep, 14, args.reps)
    for label, n, k in (("5 Mbp", 5_000_000, 13), ("config #5", args.n, 14)):
        index = _index(n, args.seed)
        reps = args.reps if n > 10 ** 8 else 10 * args.reps
        out[f"{label} seed table"], refk = _seed_tables(
            libs, label, index, k, reps)
        bbits, shift = _direct_plan(index.n, k)
        out[f"{label} bucket starts"] = _buckets(
            libs, label, [(refk, 0, index.n)], k, bbits, shift, reps)
        if n > 10 ** 8:                     # 6b: -shard -slabs 8
            slab, s, R, bases, _ = sharded._slab_plan(refk, index.n, k, 8,
                                                      3 << 30)
            refk_p, _ = sharded._pad_rows(refk, index.sa, k, slab * 8)
            out[f"{label} 8 slab tables"] = _buckets(
                libs, f"{label} 8 slabs", [
                    (refk_p[i * slab:(i + 1) * slab], int(bases[i]),
                     index.n - i * slab) for i in range(8)],
                k, R.bit_length() - 1, s, reps)
            del refk_p
        del index, refk
        torch.cuda.empty_cache()
    _log(smi)
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
