"""Finds a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose ``file``
the manifest gives, and a traffic mix, ``benchmark/traffic/<name>.json``,
whose ``kind`` is the class ``Kind`` of ``benchmark/traffic/kinds/<kind>.py``.
Each metric is a reader of its own, ``benchmark/metrics/<name>.py``, with
one function ``read(run) -> float | None`` (None: nothing to read in this
run). Adding a configuration, a mix, a kind of mix or a metric adds files
and manifest entries; no file of the harness changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(workload: str, manifest: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell named ``workload``, with its configuration and traffic mix
    read and the metrics it reports picked: an end-to-end metric with no
    ``workloads`` key is in every cell, a per-layer one in every cell that
    reports the end-to-end metric it moves."""
    manifest = load_manifest(root) if manifest is None else manifest
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {', '.join(sorted(cells))}")
    w = cells[workload]
    cfg = next(c for c in manifest["configs"] if c["name"] == w["config"])
    end_to_end = [m for m in manifest["end_to_end"]
                  if _applies(m, workload, set())]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if _applies(m, workload, reported)]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=cfg["name"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads(
            (root / "benchmark" / "traffic" / f"{w['traffic']}.json")
            .read_text()),
        end_to_end=end_to_end, per_layer=per_layer)


def _load(path: Path, prefix: str):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(name: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    return _load(root / "benchmark" / "metrics" / f"{name}.py",
                 "benchmark_metric_").read


def load_kind(kind: str, root: Path = ROOT) -> type:
    """The class ``Kind`` of ``benchmark/traffic/kinds/<kind>.py``."""
    return _load(root / "benchmark" / "traffic" / "kinds" / f"{kind}.py",
                 "benchmark_kind_").Kind
