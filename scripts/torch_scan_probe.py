#!/usr/bin/env python3
"""A/B probe of the scan kernel (``slamem_tpu_torch/kernels/csrc/rank.cu``)
on one card.

    python3 scripts/torch_scan_probe.py --old DIR [--variant LABEL=DIR ...]

Builds the scan kernel of this checkout, of the checkout DIR (its
``slamem_tpu_torch/``; an older design, e.g. a ``git archive`` of the
parent commit in an ignored directory) and of each variant, each from a
copy of its ``rank.cu`` with an entry point appended that reports both
scan kernels' registers, local memory and resident blocks per SM
(``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
and the yardsticks of ``scripts/torch_scan_probe.cu``; all in one process
on one card. Inputs are made from ``--seed`` as ``chip_smoke.py`` makes
them: the 5 Mbp pair of phase 2s (one full 4M chunk at ``-l 20``) and the
40 Mbp pair of phase 3c (its first chunk at ``-l 50``). On each chunk:
the plain lockstep loop once, with its trace (``scan_mode.ScanTrace``);
every build's kernel == the plain loop on both tables, exact; every
build's time on both tables by CUDA events, in turns (old, variants, this
checkout, then the reverse; the mean of the two); two yardsticks over the
trace's rank-row reads (2 an attempt that reads rows) with no dependence
between them: (a) whole 512 B rows, (b) only the sectors the
nearer-counter count reads; and the sectors each design touches
(``chip_smoke._scan_sectors``). Prints ``[probe]`` lines and a last JSON
line; needs a CUDA card and nvcc (CUDA_HOME or /usr/local/cuda).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from slamem_tpu_torch.engine import scan_mode, seed_mode  # noqa: E402
from slamem_tpu_torch.index.build import build_index  # noqa: E402
from slamem_tpu_torch.kernels import BUILD_DIR, build_nvcc, rank  # noqa: E402
from slamem_tpu_torch.utils import synth  # noqa: E402

LANE_BLOCK = 256
# appended to each copy of rank.cu (same translation unit, so the
# anonymous namespace's kernels are in reach): registers, local bytes,
# resident blocks per SM and warps per block of scan_lanes_kernel<layout>
_ATTRS = """
template <class K>
static int probe_attrs(K kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kWarpsPerBlock * 32, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = blocks;
  out[3] = kWarpsPerBlock;
  return static_cast<int>(err);
}

extern "C" int probe_scan_attrs(int layout, int* out) {
  return layout == 0 ? probe_attrs(scan_lanes_kernel<K0Layout>, out)
                     : probe_attrs(scan_lanes_kernel<NibLayout>, out);
}
"""


def _log(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


class _Build:
    """One tree's rank.cu (with the attributes entry appended), built."""

    def __init__(self, label: str, root: Path) -> None:
        self.label = label
        work = BUILD_DIR / "scan_probe" / label
        work.mkdir(parents=True, exist_ok=True)
        src = work / "rank.cu"
        src.write_text((root / "slamem_tpu_torch" / "kernels" / "csrc" /
                        "rank.cu").read_text() + _ATTRS)
        path, _ = build_nvcc(src, f"scan_probe_{label}")
        lib = ctypes.CDLL(str(path))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        self.scan = {}
        for layout in rank.SCAN_LAYOUTS:
            fn = getattr(lib, f"slamem_scan_lanes_{layout}")
            fn.argtypes = [vp] * 4 + [i64, i32, i32, i32, vp, vp, vp]
            fn.restype = ctypes.c_int
            self.scan[layout] = fn
        self._attrs = lib.probe_scan_attrs
        self._attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        self._attrs.restype = ctypes.c_int

    def attrs(self, layout: str) -> dict:
        out = (ctypes.c_int * 4)()
        err = self._attrs(0 if layout == "k0" else 1, out)
        if err:
            raise RuntimeError(f"{self.label}: attributes: CUDA error {err}")
        return {"registers": out[0], "local_bytes": out[1],
                "blocks_per_sm": out[2], "warps_per_block": out[3]}


class _Yardsticks:
    """``scripts/torch_scan_probe.cu``, built."""

    def __init__(self) -> None:
        path, _ = build_nvcc(Path(__file__).with_suffix(".cu"),
                             "scan_probe_yardsticks")
        lib = ctypes.CDLL(str(path))
        self.warps = lib.probe_row_read_warps
        self.warps.argtypes = [ctypes.c_int64]
        self.warps.restype = ctypes.c_int64
        self.fn = lib.probe_row_reads
        self.fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int32,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def launcher(self, rows, pos, layout: str, sectors_only: bool):
        per_row = rank.SCAN_LAYOUTS[layout]
        per_chunk = per_row // (rank.ROW_WORDS // 4 - 1)
        out = torch.empty(32 * self.warps(pos.numel()), dtype=torch.int32,
                          device=rows.device)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            if self.fn(rows.data_ptr(), pos.data_ptr(), pos.numel(), per_row,
                       per_chunk, rows.shape[0] - 1, int(sectors_only),
                       out.data_ptr(), stream):
                raise RuntimeError("yardstick launch failed")
        return run


def _chunk(label: str, builds: list, yard: _Yardsticks, ref, qry, L: int,
           reps: int) -> dict:
    index = build_index(ref, device="cuda")
    pyr = scan_mode.get_pyramid(index)
    qt = seed_mode.query_to_device(qry, "cuda")[1][
        :scan_mode._SCAN_CHUNK + L].contiguous()
    m = qt.numel()
    tables = {"nib": rank.nibble_rows(index),
              "k0": rank.interleaved_rows(index)}
    trace = scan_mode.ScanTrace()
    want = scan_mode._scan_lanes(
        index, pyr, lambda c, p: rank.rank_rows_nib_plain(tables["nib"], c, p),
        qt, L, LANE_BLOCK, trace)
    torch.cuda.synchronize()
    arg = rank._Pyramid()
    arg.nlev = len(pyr.levels)
    for k, lv in enumerate(pyr.levels):
        arg.level[k] = lv.data_ptr()
        arg.size[k] = lv.numel()
    out_lo = torch.empty(m, dtype=torch.int32, device="cuda")
    out_w = torch.empty_like(out_lo)
    stream = torch.cuda.current_stream().cuda_stream
    res = {"positions": m, "attempts": sum(trace.attempts),
           "expansions": sum(e.shape[1] for e in trace.expand)}
    pos = torch.cat([o.reshape(-1) for o in trace.occ]).contiguous()
    for layout, rows in tables.items():
        runs = {}
        for b in builds:
            def run(fn=b.scan[layout], rows=rows):
                if fn(rows.data_ptr(), index.counts.data_ptr(),
                      ctypes.addressof(arg), qt.data_ptr(), m, pyr.n, L,
                      LANE_BLOCK, out_lo.data_ptr(), out_w.data_ptr(),
                      stream):
                    raise RuntimeError("scan kernel launch failed")
            out_lo.fill_(-1)
            out_w.fill_(-1)
            run()
            torch.cuda.synchronize()
            if not (torch.equal(out_lo, want[0]) and
                    torch.equal(out_w, want[1])):
                raise AssertionError(f"{label} {layout}: {b.label}'s kernel "
                                     "!= the plain loop")
            runs[b.label] = run
        times = chip_smoke._turns(runs, reps)
        yards = chip_smoke._turns(
            {"whole rows": yard.launcher(rows, pos, layout, False),
             "sectors": yard.launcher(rows, pos, layout, True)}, reps)
        sectors = chip_smoke._scan_sectors(rank, trace, pyr, layout, m)
        attrs = {b.label: b.attrs(layout) for b in builds}
        res[layout] = {"ms": times, "yardstick_ms": yards, "attrs": attrs,
                       "sectors": sectors}
        _log(f"{label} {layout}: exact; " + ", ".join(
            f"{name} {ms:.6f} ms ({attrs[name]['registers']} regs, "
            f"{attrs[name]['local_bytes']} B local, "
            f"{attrs[name]['blocks_per_sm']} blocks/SM)"
            for name, ms in times.items()))
        _log(f"{label} {layout}: {pos.numel()} rank-row reads without "
             f"dependence: whole rows {yards['whole rows']:.6f} ms, sectors "
             f"only {yards['sectors']:.6f} ms; sectors touched: old design "
             f"{sectors['old']} (rows {sectors['rows_old']}, blocks "
             f"{sectors['blocks_old']}), new {sectors['new']} (rows "
             f"{sectors['rows_new']}, blocks {sectors['blocks_new']}), LCP "
             f"{sectors['lcp']}, streams {sectors['stream']}")
    _log(f"{label}: {m} positions, {res['attempts']} attempts, "
         f"{res['expansions']} expansions")
    return res


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
    with ThreadPoolExecutor(len(trees) + 1) as ex:
        yard = ex.submit(_Yardsticks)
        builds = list(ex.map(lambda kv: _Build(*kv), trees.items()))
        yard = yard.result()
    out = {"card": smi}
    for label, cfg, L in (("2s", chip_smoke.HEADLINE, chip_smoke.HEADLINE_L),
                          ("3c chunk", chip_smoke.CHR21, chip_smoke.CHR21_L)):
        ref, qry = synth.strain_pair(cfg["n"], seed=args.seed,
                                     sub_rate=cfg["sub_rate"],
                                     indel_rate=cfg["indel_rate"])
        out[label] = _chunk(label, builds, yard, ref, qry, L, args.reps)
        torch.cuda.empty_cache()
    _log(smi)
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
