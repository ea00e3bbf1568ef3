"""The plain reference against a brute-force count of MEMs, its listing's
layout, and its control, which must miss MEMs."""

import numpy as np
import pytest
import torch

from benchmark.inputs import synth
from benchmark.reference.listing import expected_listing, joined, render
from benchmark.reference.mems import ReferenceTable, seed_plan

CPU = torch.device("cpu")


def brute_mems(ref, qry, min_len):
    """Every maximal run of equal bases (< 4) on every diagonal, by a loop
    over the diagonals: (ref pos, query pos, length) by (query, ref)."""
    out = []
    n, m = ref.size, qry.size
    for d in range(-(m - 1), n):
        r0, r1 = max(0, d), min(n, m + d)
        eq = (ref[r0:r1] == qry[r0 - d:r1 - d]) & (ref[r0:r1] < 4)
        run = 0
        for i, e in enumerate(list(eq) + [False]):
            if e:
                run += 1
                continue
            if run >= min_len:
                s = r0 + i - run
                out.append((s, s - d, run))
            run = 0
    return sorted(out, key=lambda t: (t[1], t[0]))


def _copies(codes, count, length, rng):
    """``count`` segments of ``length`` bases copied from one random place
    to another: repeats."""
    out = codes.clone()
    for _ in range(count):
        src, dst = rng.integers(0, codes.numel() - length, 2)
        out[dst:dst + length] = out[src:src + length].clone()
    return out


def _n_runs(codes, count, length, rng):
    """``count`` stretches of ``length`` N codes (4): assembly gaps."""
    out = codes.clone()
    for start in rng.integers(0, codes.numel() - length, count):
        out[start:start + length] = 4
    return out


def pair(seed, n=1500, sub=0.04, ns=True):
    rng = np.random.default_rng(seed)
    ref = synth.random_genome(n, synth.generator(seed, 0, CPU))
    ref = _copies(ref, 4, 120, rng)
    if ns:
        ref = _n_runs(ref, 2, 15, rng)
    qry = synth.mutate(ref, sub, 0.004, synth.generator(seed, 1, CPU))
    if ns:
        qry = _n_runs(qry, 2, 10, rng)
    return ref, qry


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("min_len", [8, 13, 20, 31])
def test_reference_equals_brute_force(seed, min_len):
    ref, qry = pair(seed)
    r, q, ln = ReferenceTable(ref, min_len).find_mems(qry)
    got = list(zip(r.tolist(), q.tolist(), ln.tolist()))
    assert got == brute_mems(ref.numpy(), qry.numpy(), min_len)


@pytest.mark.parametrize("min_len", [1, 2, 40, 61, 62, 100])
def test_seed_plan_is_complete(min_len):
    k, s = seed_plan(min_len)
    assert 1 <= k <= 31 and s >= 1 and k + s - 1 == min_len


def test_reference_across_separators_and_sequences():
    ref1, qry = pair(10, n=800)
    ref2, _ = pair(11, n=600)
    text, starts = joined([ref1.numpy(), ref2.numpy()])
    assert text[starts[1] - 1] == 5 and list(starts) == [0, 801]
    q = np.concatenate([qry.numpy()[:300], ref2.numpy()[100:400]])
    r, qq, ln = ReferenceTable(torch.from_numpy(text), 12).find_mems(
        torch.from_numpy(q))
    assert list(zip(r.tolist(), qq.tolist(), ln.tolist())) == brute_mems(
        text, q, 12)


def test_render_layout():
    one = render(["chr"], ["q1", "q2"], [
        (np.array([0, 0]), np.array([4, 0]), np.array([9, 12]),
         np.array([31, 123456789])),
        (np.zeros(0, int), np.zeros(0, int), np.zeros(0, int),
         np.zeros(0, int))])
    assert one == ("> q1\n       5        10        31\n"
                   "       1        13  123456789\n> q2\n")
    many = render(["a", "long"], ["q"], [
        (np.array([1]), np.array([0]), np.array([2]), np.array([20]))])
    assert many == "> q\n  long         1         3        20\n"


def test_expected_listing_counts_every_entry():
    ref, qry = pair(20, n=2000, ns=False)
    q2 = synth.mutate(ref, 0.02, 0.0, synth.generator(20, 5, CPU))
    text, n = expected_listing(["r"], [ref.numpy()], ["a", "b"],
                               [qry.numpy(), q2.numpy()], 20, CPU)
    assert text.count(">") == 2
    assert n == len(brute_mems(ref.numpy(), qry.numpy(), 20)) + len(
        brute_mems(ref.numpy(), q2.numpy(), 20))
    assert len(text.splitlines()) == n + 2


def test_control_misses_a_mem_between_samples():
    """A MEM of length exactly L whose window starts all lie between the
    control's samples: the reference finds it, the control does not."""
    L = 30
    k, s = seed_plan(L)
    g = synth.generator(5, 0, CPU)
    ref = synth.random_genome(4000, g)
    qry = synth.random_genome(2000, synth.generator(5, 1, CPU))
    # plant ref[1000:1030] at query position p = 1 mod (s + 1), with
    # mismatching flanks
    p = (s + 1) * 20 + 1
    qry[p:p + L] = ref[1000:1000 + L]
    qry[p - 1] = (ref[999] + 1) % 4
    qry[p + L] = (ref[1000 + L] + 1) % 4
    table = ReferenceTable(ref, L)
    want = set(zip(*(x.tolist() for x in table.find_mems(qry))))
    got = set(zip(*(x.tolist() for x in table.find_mems(qry, s + 1))))
    assert (1000, p, L) in want
    assert (1000, p, L) not in got
    assert got < want
