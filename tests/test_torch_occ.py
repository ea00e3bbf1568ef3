"""The FM-index's occ checkpoints and C[] on the CPU (``index/build.py``):
``occ_checkpoints_plain`` against a numpy reckoning of every checkpoint
row, C[] from the last row against the four passes over the text it
replaced, the wrapper's checks and the ``index_build`` span's launch
count. The kernel itself runs in tests/test_torch_cuda.py.

Tolerance: exact — counts are integers.
"""

import numpy as np
import pytest
import torch

from slamem_tpu_torch.config import Config
from slamem_tpu_torch.engine.run import run_engine
from slamem_tpu_torch.index import build
from slamem_tpu_torch.index.build import (BWT_SENTINEL, build_index,
                                          occ_checkpoints,
                                          occ_checkpoints_plain)
from slamem_tpu_torch.io.fasta import CODE_N, CODE_SEP, FastaSet
from slamem_tpu_torch.utils.synth import random_genome, with_n_runs

torch.set_num_threads(1)

OCC_BLOCKS = (4, 16, 32, 64, 128)
TILE = 16_384   # csrc/occ.cu's tile: a block's bytes


def _lengths(block):
    """n = 1, a block less one, a block, a block and one, a tile edge and
    one past 2^20."""
    return sorted({1, max(block - 1, 1), block, block + 1, TILE - 1, TILE,
                   TILE + 1, (1 << 20) + 3})


def _bwt_like(n, seed):
    """Random codes 0..3 with N, SEP and the sentinel among them."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, size=n).astype(np.uint8)
    for code, share in ((CODE_N, 40), (CODE_SEP, 90)):
        b[rng.integers(0, n, size=max(1, n // share))] = code
    b[rng.integers(0, n)] = BWT_SENTINEL
    return b


def reckon(bwt, block):
    """Row r: ACGT counts in bwt[:min(r * block, n)], by a cumsum of one-hot
    columns read at each checkpoint's end."""
    n = bwt.size
    ends = np.minimum(np.arange(-(-n // block) + 1, dtype=np.int64) * block,
                      n)
    hot = np.stack([bwt == c for c in range(4)], axis=1).astype(np.int64)
    prefix = np.concatenate([np.zeros((1, 4), np.int64),
                             np.cumsum(hot, axis=0)])
    return prefix[ends].astype(np.int32)


@pytest.mark.parametrize("occ_block,n", [(b, n) for b in OCC_BLOCKS
                                         for n in _lengths(b)])
def test_plain_checkpoints_equal_numpy(occ_block, n):
    bwt = _bwt_like(n, seed=occ_block * 7919 + n)
    got = occ_checkpoints(torch.from_numpy(bwt), occ_block)
    assert got.dtype == torch.int32
    assert got.shape == (-(-n // occ_block) + 1, 4)
    np.testing.assert_array_equal(got.numpy(), reckon(bwt, occ_block))
    np.testing.assert_array_equal(
        occ_checkpoints_plain(torch.from_numpy(bwt), occ_block).numpy(),
        got.numpy())


def _text_passes(text_with_sep):
    """C[] as _finish_index worked it out before: four passes over the
    text for the ACGT totals, the specials below them."""
    t = np.asarray(text_with_sep)
    chars = np.array([(t == c).sum() for c in range(4)], np.int64)
    special = t.size - chars.sum()
    return (special + np.concatenate([[0], np.cumsum(chars)[:3]])).astype(
        np.int32)


def _joined(lengths, seed):
    seqs = [with_n_runs(random_genome(m, seed=seed + i), 2, 7, seed=seed + i)
            for i, m in enumerate(lengths)]
    ls = np.array([len(s) for s in seqs], np.int64)
    return FastaSet(names=[str(i) for i in range(len(seqs))],
                    starts=np.concatenate(([0], np.cumsum(ls)[:-1])),
                    lengths=ls, codes=np.concatenate(seqs)
                    ).with_separators()[0]


COUNT_TEXTS = {
    "n_runs": lambda: with_n_runs(random_genome(5_000, seed=31), 5, 50,
                                  seed=32),
    "separators": lambda: _joined((700, 1, 64, 2_000), seed=33),
    "all_n": lambda: np.full(300, CODE_N, np.uint8),
    "one_base": lambda: np.array([3], np.uint8),
    "ragged": lambda: _bwt_like(4_099, seed=34).clip(0, CODE_SEP),
}


@pytest.mark.parametrize("occ_block", [4, 128])
@pytest.mark.parametrize("name", sorted(COUNT_TEXTS))
def test_counts_from_last_row_equal_text_passes(name, occ_block):
    text = COUNT_TEXTS[name]()
    idx = build_index(text, occ_block=occ_block, device="cpu")
    full = np.concatenate([text, [CODE_SEP]]).astype(np.uint8)
    np.testing.assert_array_equal(idx.counts.numpy(), _text_passes(full))
    np.testing.assert_array_equal(
        idx.occ_ckpt[-1].numpy(),
        [(full == c).sum() for c in range(4)])
    assert idx.counts.dtype == torch.int32


@pytest.mark.parametrize("bad", ["dtype", "2d", "strided", "block0"])
def test_occ_checkpoints_checks_its_arguments(bad):
    bwt = torch.zeros(64, dtype=torch.uint8)
    args = {"dtype": (bwt.to(torch.int32), 16),
            "2d": (bwt.view(8, 8), 16),
            "strided": (bwt[::2], 16),
            "block0": (bwt, 0)}[bad]
    with pytest.raises(ValueError):
        occ_checkpoints(*args)


def test_cpu_build_takes_the_plain_path(monkeypatch):
    """A CPU build neither builds nor launches the occ or the window-key
    kernel, and its ``index_build`` span records 0 launches and its sorts
    (1 for a random reference; a given index: 0 and 0)."""
    def no_kernel():
        raise AssertionError("a kernel was loaded for CPU tensors")

    monkeypatch.setattr(build, "load_occ", no_kernel)
    monkeypatch.setattr(build, "load_sa_keys", no_kernel)
    before = occ_checkpoints.launches
    ref = with_n_runs(random_genome(3_000, seed=41), 2, 20, seed=42)
    mk = lambda c: FastaSet(names=["r"], starts=np.array([0]),  # noqa: E731
                            lengths=np.array([len(c)]), codes=c)
    out = run_engine(mk(ref), mk(ref[500:900].copy()), Config(min_length=20),
                     device="cpu")
    rec = out.stats["phases"][0]
    assert rec["phase"] == "index_build" and rec["occ_launches"] == 0
    assert rec["sa_sorts"] == 1
    idx = build_index(ref, device="cpu")
    out = run_engine(mk(ref), mk(ref[:300].copy()), Config(min_length=20),
                     index=idx, device="cpu")
    rec = out.stats["phases"][0]
    assert rec["occ_launches"] == 0 and rec["sa_sorts"] == 0
    assert occ_checkpoints.launches == before
