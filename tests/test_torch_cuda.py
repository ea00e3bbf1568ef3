"""Port on the card: the CUDA rank kernel and the scan slice on a CUDA
device, against their plain versions on the same inputs.

These tests need a CUDA card (marker ``cuda``) and skip without one. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact — occ counts and match tuples are integers.
"""

import numpy as np
import pytest
import torch

from slamem_tpu_torch.config import Config
from slamem_tpu_torch.engine.scan_mode import find_scan_matches
from slamem_tpu_torch.index.build import build_index, rank_batch
from slamem_tpu_torch.kernels import rank
from slamem_tpu_torch.utils.synth import mutate, random_genome, with_n_runs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_rank_kernel_equals_plain(cuda):
    t = with_n_runs(random_genome(60_000, seed=148), 2, 30, seed=149)
    idx = build_index(t, device=cuda)
    rows = rank.interleaved_rows(idx)
    rng = np.random.default_rng(147)
    pos = np.concatenate([rng.integers(0, idx.n + 1, 100_000),
                          [0, 1, 495, 496, 497, idx.n - 1, idx.n]])
    chars = rng.integers(0, 4, pos.size)
    p = torch.from_numpy(pos.astype(np.int32)).to(cuda)
    c = torch.from_numpy(chars.astype(np.int32)).to(cuda)
    before = rank.rank_rows.launches
    got = rank.rank_rows(rows, c, p)
    torch.cuda.synchronize()
    assert rank.rank_rows.launches == before + 1
    assert torch.equal(got, rank.rank_rows_plain(rows, c, p))
    assert torch.equal(got, rank_batch(idx, c, p))
    with pytest.raises(ValueError):
        rank.rank_rows(rows, c, p.cpu())


def test_scan_slice_cuda_equals_cpu(cuda):
    ref = with_n_runs(random_genome(30_000, seed=150), 3, 40, seed=151)
    qry = mutate(ref, 0.015, 0.0015, seed=152)
    cfg = Config(min_length=20, engine="scan")
    got = find_scan_matches(build_index(ref, device=cuda), qry, cfg)
    want = find_scan_matches(build_index(ref, device="cpu"), qry, cfg)
    for f in ("refpos", "qpos", "length"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.length.size > 0
