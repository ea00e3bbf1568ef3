"""The traced window: ``torch.profiler`` over the measured answers, reduced
to the device's busy time, its idle gaps and what the host was doing in
them.

Host spans are ``record_function`` labels that start with ``bench:``: the
harness's own (``bench:window``, ``bench:job``, ``bench:request``,
``bench:render``) and, in a traced run only, wrappers around the calls
into the program's layers (``host_spans``). A wrapper waits for the card
before its span closes, so the span holds the device work its call
launched.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
from collections import defaultdict

from benchmark.harness.arith import complement, coverage, union_length

WINDOW = "bench:window"

# (module, attribute, span label): the program's layers, as a job or a
# request calls them
LAYERS = (
    ("slamem_tpu_torch.io.fasta", "read_fasta", "bench:read_fasta"),
    ("slamem_tpu_torch.engine.run", "build_index", "bench:index_build"),
    ("slamem_tpu_torch.engine.run", "_search_one", "bench:engine_search"),
    ("slamem_tpu_torch.engine.run", "run_engine", "bench:run_engine"),
    ("slamem_tpu_torch.report.format", "format_matches", "bench:render"),
)


@contextlib.contextmanager
def host_spans():
    """Wrap each layer's entry in a ``record_function`` span while the
    traced window runs; restores the originals after."""
    import torch
    from torch.profiler import record_function

    saved = []
    for mod_name, attr, label in LAYERS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                out = _fn(*a, **kw)
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                return out

        saved.append((mod, attr, fn))
        setattr(mod, attr, functools.wraps(fn)(wrapped))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _is_device_op(ev) -> bool:
    """A kernel, copy or fill on the card: every device event but the
    GPU-side copies of the host spans, which cover a span's first to last
    kernel, gaps and all."""
    return (ev.device_type().name == "CUDA"
            and not ev.name().startswith("bench:"))


def _innermost(spans: list[tuple[int, int, str]]
               ) -> tuple[list[int], list[str | None]]:
    """The timeline cut where a span starts or ends: (cut times, the
    innermost open span after each cut). Spans nest: they are the
    labels of one thread's ``record_function`` calls."""
    # at one instant: closes before opens, the inner span closing first
    # and opening last
    points = sorted([(a, 1, -b, n) for a, b, n in spans]
                    + [(b, 0, -a, n) for a, b, n in spans])
    stack: list[str] = []
    seg_t, seg_label = [], []
    for t, opens, _, name in points:
        if opens:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        seg_t.append(t)
        seg_label.append(stack[-1] if stack else None)
    return seg_t, seg_label


def reduce(prof, top: int = 10) -> dict:
    """busy_s, window_s and the breakdown from a finished profile:
    ``device_ops`` = device time summed by operation name, ``idle_gaps`` =
    idle device time summed by the innermost ``bench:`` host span open
    over it, each the ``top`` largest, in seconds; and ``spans``: for each
    host span's label, how many the window holds and the device's busy
    seconds inside them (``count``, ``device_s``)."""
    events = prof.profiler.kineto_results.events()
    window = None
    spans = []
    device = []
    for ev in events:
        name = ev.name()
        if _is_device_op(ev):
            device.append((ev.start_ns(), ev.end_ns(), name))
        elif name.startswith("bench:") and ev.device_type().name == "CPU":
            spans.append((ev.start_ns(), ev.end_ns(), name))
            if name == WINDOW:
                window = (ev.start_ns(), ev.end_ns())
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    lo, hi = window
    busy, gaps = union_length([(a, b) for a, b, _ in device], lo, hi)
    by_op = defaultdict(int)
    for a, b, name in device:
        if b > lo and a < hi:
            by_op[name[:160]] += min(b, hi) - max(a, lo)
    busy_in = coverage(complement(gaps, lo, hi))
    by_span: dict[str, dict] = {}
    for a, b, name in spans:
        if name != WINDOW and lo <= a and b <= hi:
            s = by_span.setdefault(name, {"count": 0, "device_s": 0.0})
            s["count"] += 1
            s["device_s"] += busy_in(a, b) / 1e9
    seg_t, seg_label = _innermost(spans)
    by_host = defaultdict(int)
    for a, b in gaps:
        # each part of the gap goes to the span innermost over it
        i = bisect.bisect_right(seg_t, a) - 1
        t = a
        while t < b:
            nxt = seg_t[i + 1] if i + 1 < len(seg_t) else b
            end = min(max(nxt, t), b)
            if end > t:
                by_host[seg_label[i] if i >= 0 else None] += end - t
            t = end
            i += 1

    def ranked(d):
        return [[k or "outside any span", v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
            "breakdown": {"device_ops": ranked(by_op),
                          "idle_gaps": ranked(by_host)},
            "spans": by_span}
