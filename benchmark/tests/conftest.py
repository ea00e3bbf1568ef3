"""The benchmark's own tests (CPU; the ``cuda`` ones skip without a card):
``python -m pytest benchmark/tests -q`` from the checkout's root."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)

# each configuration cut to a size a CPU test holds; every other key as
# the configuration file has it
TINY = {"chr1-pair": {"reference_length": 120_000, "query_length": 30_000},
        "salmonella10": {"reference_length": 15_000}}


@pytest.fixture
def tiny_cell():
    from benchmark.harness.manifest import load_cell

    def make(workload: str, **changes):
        cell = load_cell(workload)
        cell.config.update(TINY[cell.config_name], **changes)
        if cell.config_name == "salmonella10":
            cell.config["query_entries"] = cell.config["query_entries"][:4]
        return cell

    return make
