"""Profiling hook (port of ``slamem_tpu/utils/profile.py``).

With ``SLAMEM_TRACE_DIR`` set, ``maybe_trace`` records the enclosed region
with ``torch.profiler`` (host ops, and the card's kernels when the process
has one) and writes a Chrome trace (``chrome://tracing``, Perfetto) into
that directory: ``<label>.<pid>.trace.json``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager


@contextmanager
def maybe_trace(label: str = "slamem"):
    """Trace the enclosed region if SLAMEM_TRACE_DIR is set."""
    trace_dir = os.environ.get("SLAMEM_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(label):
            yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"{label}.{os.getpid()}.trace.json"))
