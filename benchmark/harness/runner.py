"""One run of one cell: inputs from the seed, the mix's set-up, the window,
then the checks against the plain reference, which runs after the
window, once the device peak is read and the program's state is freed."""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from benchmark.harness import checks, imports, trace
from benchmark.harness.manifest import Cell, load_kind, load_metric
from benchmark.harness.traffic import Answer
from benchmark.inputs.build import Inputs, make_inputs
from benchmark.reference.listing import expected_listing


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    inputs: Inputs
    setup_s: float
    window_s: float
    answers: list[Answer]
    trace: dict | None            # busy_s, window_s, breakdown

    @property
    def reference_symbols(self) -> int:
        """n of the program's index: the references joined by separators,
        plus the terminator."""
        refs = self.inputs.refs
        return int(sum(r.size for r in refs)) + len(refs)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    proc = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    return (proc.stdout or proc.stderr).strip()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float,
             t_torch: float | None = None) -> tuple[dict, dict]:
    """(result line, compared numbers). ``t_start``: when the harness
    started, ``t_torch``: when it had imported torch."""
    cuda = device.type == "cuda"
    marks = Marks(t_start, device)
    if t_torch is not None:
        marks.parts.append(("import torch", t_torch - t_start))
        marks.t = t_torch
    marks("card context and imports")
    inputs = make_inputs(cell.config, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    marks("inputs")
    log(f"inputs: {len(inputs.refs)} reference sequence(s), "
        f"{sum(r.size for r in inputs.refs)} bp; {len(inputs.queries)} "
        f"query entries, {inputs.query_bases} bp")
    with tempfile.TemporaryDirectory(prefix="slamem-bench-") as work:
        mix = load_kind(cell.traffic["kind"])(
            cell.traffic, cell.config, inputs, work, device, seed)
        mix.prepare()
        marks(mix.prepared)
        mix.answer(-1, False)
        marks("warm answer")
        prof = trace.profiler(device) if traced else None
        if traced:
            prof.start()
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        marks("profiler start" if traced else "end")
        log("set-up, s: " + "; ".join(f"{k} {v:.3f}" for k, v in marks.parts))
        with (trace.host_spans() if traced
              else contextlib.nullcontext()):
            answers, window_s = mix.window(seconds, traced)
        if cuda:
            torch.cuda.synchronize(device)
        summary = None
        if traced:
            prof.stop()
            summary = trace.reduce(prof)
            del prof
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        walls = sorted(a.wall_s for a in answers)
        log(f"window: {len(answers)} {mix.unit}s in {window_s:.3f} s "
            f"(first {answers[0].wall_s:.4f} s, min {walls[0]:.4f}, median "
            f"{walls[len(walls) // 2]:.4f}, max {walls[-1]:.4f}); "
            f"set-up {setup_s:.3f} s; device peak {peak} bytes "
            f"({peak / 2**30:.3f} GiB); card: "
            f"{card_line() if cuda else 'none (cpu)'}")
        kept = mix.kept()
        mix.release()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        expected, n_mems = expected_listing(
            inputs.ref_names, inputs.refs, inputs.query_names,
            inputs.queries, int(cell.config["min_length"]), device)
        numbers, wrong = checks.compare(
            expected, [a.size for a in answers], kept)
        log(f"reference: {n_mems} MEMs in {time.perf_counter() - t_ref:.3f}"
            f" s; answers checked line by line: {sorted(kept)}")
    run = Run(cell=cell, inputs=inputs, setup_s=setup_s, window_s=window_s,
              answers=answers, trace=summary)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_metric(m["name"])(run)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": checks.passed(numbers) and bool(kept),
              "attempted": len(answers), "failed": len(wrong),
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    found = imports.forbidden(sys.modules)
    if found:
        raise ForbiddenImport(found)
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]}
                        for k, v in numbers.items()}
    return result, numbers


class Marks:
    """Set-up's parts: seconds since the previous mark (the first since
    the harness started: imports and the card's context)."""

    def __init__(self, t_start: float, device: torch.device):
        self.t = t_start
        self.device = device
        self.parts: list[tuple[str, float]] = []

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now


class ForbiddenImport(RuntimeError):
    def __init__(self, names: list[str]):
        super().__init__("the run loaded " + ", ".join(names))
        self.names = names

