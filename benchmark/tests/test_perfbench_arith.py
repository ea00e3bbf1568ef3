"""The harness's arithmetic: percentiles, rates, the union of device
intervals, the attribution of idle gaps and the index's bytes."""

import numpy as np
import pytest

from benchmark.harness import arith, trace


@pytest.mark.parametrize("p", [0, 5, 50, 90, 95, 99, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 200])
def test_percentile_is_numpy_linear(p, n):
    xs = list(np.random.default_rng(n).exponential(size=n))
    assert arith.percentile(xs, p) == pytest.approx(np.percentile(xs, p))


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        arith.percentile([], 95)


def test_rate_and_mean():
    assert arith.rate(50.0, 0.25) == 200.0
    assert arith.mean([1.0, 2.0, 6.0]) == 3.0
    assert arith.mean([]) is None
    with pytest.raises(ValueError):
        arith.rate(1.0, 0.0)


def test_union_length_and_gaps():
    iv = [(5, 10), (8, 12), (20, 25), (0, 3), (30, 40), (11, 11)]
    covered, gaps = arith.union_length(iv, 2, 35)
    # [2,3) [5,12) [20,25) [30,35)
    assert covered == 1 + 7 + 5 + 5
    assert gaps == [(3, 5), (12, 20), (25, 30)]
    assert covered + sum(b - a for a, b in gaps) == 35 - 2


def test_union_of_nothing_is_one_gap():
    assert arith.union_length([], 0, 10) == (0, [(0, 10)])


def test_index_bytes():
    # n = 1001 symbols, B = 128: 8 blocks + 1 rows of 4 int32
    n = 1001
    assert arith.index_bytes(n, 128) == 1000 + 6 * n + 16 * 9 + 16
    # about 7.125 bytes a symbol at the CLI's spacing
    assert arith.index_bytes(250_000_001, 128) / 250e6 == pytest.approx(
        7.125, abs=1e-3)


class _Ev:
    class _Dev:
        def __init__(self, name):
            self.name = name

    def __init__(self, name, dev, a, b):
        self._n, self._d, self._a, self._b = name, self._Dev(dev), a, b

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b


class _Prof:
    def __init__(self, events):
        class K:
            def events(self_inner):
                return events

        class P:
            kineto_results = K()

        self.profiler = P()


def test_trace_reduce_busy_idle_and_attribution():
    evs = [
        _Ev("bench:window", "CPU", 0, 1000),
        _Ev("bench:request", "CPU", 0, 500),
        _Ev("bench:render", "CPU", 300, 500),
        _Ev("bench:request", "CPU", 500, 1000),
        # the GPU-side copy of a host span: not device work
        _Ev("bench:request", "CUDA", 100, 900),
        _Ev("sort", "CUDA", 100, 200),
        _Ev("sort", "CUDA", 150, 250),
        _Ev("copy", "CUDA", 600, 700),
        _Ev("aten::sort", "CPU", 100, 260),
    ]
    out = trace.reduce(_Prof(evs))
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["busy_s"] == pytest.approx(250e-9)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops == pytest.approx({"sort": 200e-9, "copy": 100e-9})
    idle = dict(out["breakdown"]["idle_gaps"])
    # idle: [0,100) [250,300) request; [300,500) render; [500,600)
    # [700,1000) request
    assert idle == pytest.approx({"bench:request": 550e-9,
                                  "bench:render": 200e-9})
    assert sum(idle.values()) + out["busy_s"] == pytest.approx(1e-6)
    # device time inside each span: request [0,500) 150, [500,1000) 100;
    # render [300,500) none
    assert out["spans"] == {
        "bench:request": {"count": 2, "device_s": pytest.approx(250e-9)},
        "bench:render": {"count": 1, "device_s": 0.0}}


@pytest.mark.parametrize("a,b,want", [
    (0, 100, 15), (0, 15, 5), (12, 18, 6), (0, 1000, 25), (25, 33, 3),
    (20, 30, 0), (31, 31, 0), (205, 300, 5)])
def test_coverage_of_a_span(a, b, want):
    busy = arith.complement([(0, 10), (20, 30), (35, 100)], 0, 100)
    assert busy == [(10, 20), (30, 35)]
    assert arith.coverage(busy + [(200, 210)])(a, b) == want


def test_complement_edges():
    assert arith.complement([], 0, 10) == [(0, 10)]
    assert arith.complement([(0, 10)], 0, 10) == []
    assert arith.complement([(3, 4)], 0, 10) == [(0, 3), (4, 10)]
