"""Profiling hook (port of ``slamem_tpu/utils/profile.py``).

With ``SLAMEM_TRACE_DIR`` set, ``maybe_trace`` records the enclosed region
with ``torch.profiler`` (host ops, and the card's kernels when the process
has one) and writes a Chrome trace (``chrome://tracing``, Perfetto) into
that directory: ``<label>.<pid>.trace.json``. Inside its own profile the
region is a ``<label>`` range and every PhaseLog span a
``slamem:<name>`` range (utils/log.py). A ``maybe_trace`` inside another
is a plain ``<label>`` range of the outer one's trace; under a profiler
the program did not start it records nothing and enters no range.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

from slamem_tpu_torch.utils import log


@contextmanager
def maybe_trace(label: str = "slamem"):
    """Trace the enclosed region if SLAMEM_TRACE_DIR is set."""
    trace_dir = os.environ.get("SLAMEM_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if log._trace_ranges:            # inside our own profile
        with record_function(label):
            yield
        return
    if torch._C._autograd._profiler_enabled():   # someone else's
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with log.trace_ranges(), record_function(label):
            yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"{label}.{os.getpid()}.trace.json"))
