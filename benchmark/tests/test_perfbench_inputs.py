"""The input generator: its statistics, and one seed giving one input."""

import numpy as np
import pytest
import torch

from benchmark.inputs import synth
from benchmark.inputs.build import make_inputs

CPU = torch.device("cpu")


def gen(seed, stream=0):
    return synth.generator(seed, stream, CPU)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 17, 2**40 + 3])
def test_random_genome_is_uniform_and_seeded(seed):
    a = synth.random_genome(400_000, gen(seed))
    b = synth.random_genome(400_000, gen(seed))
    c = synth.random_genome(400_000, gen(seed + 1))
    assert a.dtype == torch.uint8 and torch.equal(a, b)
    assert not torch.equal(a, c)
    counts = torch.bincount(a.long(), minlength=5).numpy()
    assert counts[4] == 0
    # each base 1/4 within 5 standard deviations
    assert np.all(np.abs(counts[:4] - 100_000) < 5 * np.sqrt(75_000))


@pytest.mark.parametrize("rate", [0.01, 0.03])
def test_mutate_substitutions_exact_count(rate):
    ref = synth.random_genome(200_000, gen(1))
    out = synth.mutate(ref, rate, 0.0, gen(1, 2))
    assert out.shape == ref.shape
    assert int((out != ref).sum()) == int(200_000 * rate)
    assert int(out.max()) <= 3


def test_mutate_indels_length_and_identity():
    n, rate = 500_000, 0.003
    ref = synth.random_genome(n, gen(2))
    out = synth.mutate(ref, 0.0, rate, gen(2, 3))
    k = int(n * rate)
    # deletions and insertions of 1-9 (mean 5) cancel in expectation
    assert abs(out.numel() - n) < 8 * 5 * np.sqrt(k)
    # between indels the copy is exact: most of its 16-mers occur in the
    # reference (a random 16-mer would, 1 time in ~8,600 here)
    def kmers(x):
        x = x.numpy().astype(np.uint64)
        key = np.zeros(x.size - 15, np.uint64)
        for j in range(16):
            key = key * np.uint64(4) + x[j:j + x.size - 15]
        return key

    found = np.isin(kmers(out)[::16], kmers(ref)).mean()
    assert found > 0.85
    again = synth.mutate(ref, 0.0, rate, gen(2, 3))
    assert torch.equal(out, again)


def test_mutate_inserts_and_deletes_in_equal_share():
    n = 400_000
    ref = synth.random_genome(n, gen(3))
    # no substitutions: an insertion adds bases, a deletion removes them;
    # a pure-deletion world would be ~ -5 * k
    outs = [synth.mutate(ref, 0.0, 0.002, gen(3, s)).numel() - n
            for s in range(1, 6)]
    assert abs(np.mean(outs)) < 5 * 800 * 0.5


def test_make_inputs_follows_the_configuration():
    cfg = {"reference_name": "r", "reference_length": 50_000,
           "query_entries": [{"name": "a", "sub_rate": 0.01,
                              "indel_rate": 0.001},
                             {"name": "b", "sub_rate": 0.02,
                              "indel_rate": 0.0}],
           "query_length": 20_000, "min_length": 30}
    a = make_inputs(cfg, 99, CPU)
    b = make_inputs(cfg, 99, CPU)
    assert a.ref_names == ["r"] and a.query_names == ["a", "b"]
    assert a.refs[0].size == 50_000
    assert [q.size for q in a.queries] == [20_000, 20_000]
    assert a.query_bases == 40_000
    for x, y in zip(a.refs + a.queries, b.refs + b.queries):
        assert np.array_equal(x, y)
    # entry b: substitutions only, 2% of the reference, in its first 20k
    diff = (a.queries[1] != a.refs[0][:20_000]).mean()
    assert 0.01 < diff < 0.03


@pytest.mark.parametrize("sizes", [[0], [1], [70], [71, 140, 5], [1000]])
def test_fasta_round_trip(tmp_path, sizes):
    from benchmark.harness.fasta import write_fasta
    from slamem_tpu_torch.io.fasta import parse_fasta_bytes

    rng = np.random.default_rng(len(sizes))
    seqs = [rng.integers(0, 5, n).astype(np.uint8) for n in sizes]
    names = [f"s{i}" for i in range(len(seqs))]
    path = tmp_path / "x.fa"
    write_fasta(str(path), names, seqs)
    text = path.read_bytes()
    assert all(len(line) <= 70 for line in text.split(b"\n"))
    got = parse_fasta_bytes(text)
    assert got.names == names
    assert list(got.lengths) == sizes
    assert np.array_equal(got.codes, np.concatenate(seqs))
