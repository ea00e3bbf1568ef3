#!/usr/bin/env python3
"""The PhaseLog spans on one card: their clock, and what tracing costs.

    python3 scripts/torch_span_check.py [--seed N] [--jobs 4] [--pairs 6]
        [--out build/span_check.json]

From the root of a checkout, on a machine with a CUDA card. Inputs and
jobs are the benchmark's (``benchmark/``): a cell's configuration, its
FASTA files and ``cli_job`` jobs, in this process.

1. Clock: ``--jobs`` ``chr1-pair.job`` jobs with ``-v`` and
   ``SLAMEM_LOG_JSON=1`` under the benchmark's profiler and its ``bench:``
   wrappers (``benchmark/harness/trace.py``). Each job's ``fasta_read`` /
   ``fasta_parse`` records are held to that job's ``bench:read_fasta``
   ranges, its ``render`` record to ``bench:render`` (signed ns at each
   end), and its ``index_build`` record to the card's kernels that ran
   inside the ``bench:index_build`` range (first kernel start less the
   record's start, record's end less the last kernel's end). Also: the
   names of the device events, which must hold no ``slamem:`` range.
2. Cost of tracing on: for ``chr1-pair.job`` and ``salmonella10.job``,
   ``--pairs`` pairs of jobs in turns, one with ``-v`` and JSON records
   (every engine stage synchronised), one without; the seconds of each.

Prints ``[span]`` lines and writes every number to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from benchmark.harness import trace  # noqa: E402
from benchmark.harness.manifest import load_cell, load_kind  # noqa: E402
from benchmark.inputs.build import make_inputs  # noqa: E402

MS = 1e6


def log(msg: str) -> None:
    print(f"[span] {msg}", flush=True)


def _mix(cell_name: str, seed: int, work: str, device):
    cell = load_cell(cell_name)
    inputs = make_inputs(cell.config, seed, device)
    mix = load_kind(cell.traffic["kind"])(cell.traffic, cell.config,
                                          inputs, work, device, seed)
    mix.prepare()
    mix.answer(-1, False)       # warm: every kernel built and loaded
    return mix


def _ranges(events, name: str) -> list[tuple[int, int]]:
    return sorted((ev.start_ns(), ev.end_ns()) for ev in events
                  if ev.name() == name and ev.device_type().name == "CPU")


def clock_check(seed: int, jobs: int, work: str, device) -> dict:
    mix = _mix("chr1-pair.job", seed, work, device)
    prof = trace.profiler(device)
    prof.start()
    if device.type == "cuda":   # as the benchmark's set-up: the first
        torch.cuda.synchronize(device)   # CUDA call under the profiler
    answers = []
    with trace.host_spans(), record_function("bench:window"):
        for _ in range(jobs):
            with record_function("bench:job"):
                answers.append(mix.answer(-1, True))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    events = prof.profiler.kineto_results.events()
    reads = _ranges(events, "bench:read_fasta")
    renders = _ranges(events, "bench:render")
    builds = _ranges(events, "bench:index_build")
    kernels = sorted((ev.start_ns(), ev.end_ns()) for ev in events
                     if ev.device_type().name == "CUDA"
                     and not ev.name().startswith("bench:"))
    device_names = {ev.name() for ev in events
                    if ev.device_type().name == "CUDA"}
    out = {"jobs": [], "slamem_device_events": sorted(
        n for n in device_names if n.startswith("slamem:"))}
    for j, a in enumerate(answers):
        by = {}
        for rec in a.phases:
            by.setdefault(rec["phase"], []).append(rec)
        job = {"read": [], "render": None, "build": None}
        for k, (rd, ps) in enumerate(zip(by["fasta_read"],
                                         by["fasta_parse"])):
            b0, b1 = reads[2 * j + k]
            job["read"].append({
                "read_t0_after_range_ms": (rd["t0_ns"] - b0) / MS,
                "range_end_after_parse_t1_ms": (b1 - ps["t1_ns"]) / MS,
                "read_s": rd["seconds"], "parse_s": ps["seconds"],
                "range_s": (b1 - b0) / 1e9})
        (rn,) = by["render"]
        b0, b1 = renders[j]
        job["render"] = {"range_after_t0_ms": (b0 - rn["t0_ns"]) / MS,
                         "t1_after_range_ms": (rn["t1_ns"] - b1) / MS,
                         "render_s": rn["seconds"], "range_s": (b1 - b0) / 1e9}
        (ib,) = by["index_build"]
        b0, b1 = builds[j]
        inside = [k for k in kernels if b0 <= k[0] and k[1] <= b1] or [
            (ib["t0_ns"], ib["t1_ns"])]   # none on the CPU
        job["build"] = {
            "kernels": len(inside),
            "first_kernel_after_t0_ms": (inside[0][0] - ib["t0_ns"]) / MS,
            "t1_after_last_kernel_ms": (ib["t1_ns"] - inside[-1][1]) / MS,
            "range_after_t0_ms": (b0 - ib["t0_ns"]) / MS,
            "range_end_after_t1_ms": (b1 - ib["t1_ns"]) / MS}
        out["jobs"].append(job)
        for r in job["read"]:
            log(f"job {j} read: fasta_read.t0 {r['read_t0_after_range_ms']:.4f}"
                f" ms after bench:read_fasta opens; bench:read_fasta closes "
                f"{r['range_end_after_parse_t1_ms']:.4f} ms after "
                f"fasta_parse.t1 (read {r['read_s']:.6f} s + parse "
                f"{r['parse_s']:.6f} s of the range's {r['range_s']:.6f} s)")
        r = job["render"]
        log(f"job {j} render: bench:render opens {r['range_after_t0_ms']:.4f}"
            f" ms after render.t0, render.t1 {r['t1_after_range_ms']:.4f} ms "
            f"after bench:render closes ({r['render_s']:.6f} s, range "
            f"{r['range_s']:.6f} s)")
        b = job["build"]
        log(f"job {j} index_build: {b['kernels']} device ops inside; first "
            f"starts {b['first_kernel_after_t0_ms']:.4f} ms after the "
            f"record's t0; the record's t1 {b['t1_after_last_kernel_ms']:.4f}"
            f" ms after the last ends; bench:index_build opens "
            f"{b['range_after_t0_ms']:.4f} ms after t0, closes "
            f"{b['range_end_after_t1_ms']:.4f} ms after t1")
    log(f"device events named slamem:*: {out['slamem_device_events']}")
    return out


def on_cost(cell_name: str, seed: int, pairs: int, work: str,
            device) -> dict:
    mix = _mix(cell_name, seed, work, device)
    on, off = [], []
    for _ in range(pairs):
        for traced, times in ((True, on), (False, off)):
            t0 = time.perf_counter()
            mix.answer(-1, traced)
            times.append(time.perf_counter() - t0)
    res = {"on_s": on, "off_s": off,
           "on_median_s": statistics.median(on),
           "off_median_s": statistics.median(off)}
    res["on_less_off_s"] = res["on_median_s"] - res["off_median_s"]
    log(f"{cell_name}: -v with JSON records median {res['on_median_s']:.6f}"
        f" s, without {res['off_median_s']:.6f} s "
        f"({res['on_less_off_s']:+.6f} s); on {on}; off {off}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2147483901)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default="build/span_check.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    res = {"card": torch.cuda.get_device_name(device)}
    with tempfile.TemporaryDirectory(prefix="slamem-span-") as work:
        res["clock"] = clock_check(args.seed, args.jobs, work, device)
        res["on_cost"] = {
            cell: on_cost(cell, args.seed, args.pairs, work, device)
            for cell in ("chr1-pair.job", "salmonella10.job")}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
