"""Phase log and spans (port of ``slamem_tpu/utils/log.py``).

A ``PhaseLog`` records timed spans of the host's work: each record is
``{"phase": <name>, "seconds", "t0_ns", "t1_ns", **fields}``, its ends
read from ``time.time_ns()``, the clock ``torch.profiler`` stamps its
events with, so a record lines up with a trace's host ranges and kernels.
A ``bp`` field adds the phase's Mbp/s. An enabled log prints each record
as it ends: a ``[slamem] <phase>: <s>s key=value ...`` line on stderr, or
one JSON object per line with ``SLAMEM_LOG_JSON=1``.

One log is *active* at a time (the CLI's, for a whole job): ``span``
records into it, and does nothing when no log is active. A span costs two
clock reads and one list append; only inside ``utils/profile.py``'s own
profile (``SLAMEM_TRACE_DIR``) does it also open a
``record_function("slamem:<name>")`` range of the Chrome trace.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext

_active: PhaseLog | None = None
# set by maybe_trace while its own profile runs: spans enter the trace
_trace_ranges = False


class PhaseLog:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.json_mode = os.environ.get("SLAMEM_LOG_JSON") == "1"
        self.records: list[dict] = []

    @contextmanager
    def phase(self, name: str, **fields):
        """Time a phase. Yields the mutable field dict so callers can attach
        values known only at its end (bytes, pair counts)."""
        rng = None
        if _trace_ranges:
            from torch.profiler import record_function

            rng = record_function("slamem:" + name)
            rng.__enter__()
        t0 = time.time_ns()
        try:
            yield fields
        finally:
            t1 = time.time_ns()
            if rng is not None:
                rng.__exit__(None, None, None)
            dt = (t1 - t0) / 1e9
            rec = {"phase": name, "seconds": round(dt, 6), "t0_ns": t0,
                   "t1_ns": t1, **fields}
            if "bp" in fields and dt > 0:
                rec["mbp_per_s"] = round(fields["bp"] / 1e6 / dt, 3)
            self.records.append(rec)
            if self.enabled:
                self.emit(rec)

    @contextmanager
    def activate(self):
        """Make this the log ``span`` records into, for the enclosed
        region."""
        global _active
        saved, _active = _active, self
        try:
            yield self
        finally:
            _active = saved

    def emit(self, rec: dict) -> None:
        if self.json_mode:
            print(json.dumps(rec), file=sys.stderr)
        else:
            extra = " ".join(f"{k}={v}" for k, v in rec.items()
                             if k not in ("phase", "seconds", "t0_ns",
                                          "t1_ns"))
            print(f"[slamem] {rec['phase']}: {rec['seconds']:.3f}s {extra}",
                  file=sys.stderr)


def active_log() -> PhaseLog | None:
    """The log ``span`` records into, or None."""
    return _active


def span(name: str, **fields):
    """A phase of the active log; with no log active, a context that
    yields ``fields`` and records nothing."""
    if _active is None:
        return nullcontext(fields)
    return _active.phase(name, **fields)


@contextmanager
def trace_ranges():
    """Spans enter the running profile as ``slamem:<name>`` ranges in the
    enclosed region (``maybe_trace``'s own profile only)."""
    global _trace_ranges
    saved, _trace_ranges = _trace_ranges, True
    try:
        yield
    finally:
        _trace_ranges = saved
