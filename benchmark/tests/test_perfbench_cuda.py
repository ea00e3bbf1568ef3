"""On the card: one short run of each cell through the command the
manifest names, as the checks run it. Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.manifest import ROOT, load_manifest


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("workload", ["chr1-pair.query",
                                      "salmonella10.job"])
def test_cell_on_the_card(workload, traced):
    _card()
    m = load_manifest()
    proc = subprocess.run(
        [sys.executable, *m["command"][1:], "--workload", workload,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace",
         str(traced)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    if traced:
        assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
