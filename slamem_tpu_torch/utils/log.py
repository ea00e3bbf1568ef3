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

An engine call's stages (upload, tables, frontend, expand, gather, merge,
extend, the slab programs' ``slab_*``) are the spans opened inside its
``engine_stages`` region, and ``stats['stage_s']`` sums their seconds by
name. A stage waits for the call's device at its close only with ``-v``
(``cfg.verbose``) or under a running torch profiler, so its seconds
include its kernels; otherwise it reads the host's clock alone (its
launches and the host reads that wait for the card). Spans outside an
engine call (the host's work) never wait.
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
        # the torch.device the stages of the engine call in progress wait
        # for at their close (None: they do not wait)
        self.stage_wait = None

    @contextmanager
    def phase(self, name: str, *, wait=None, **fields):
        """Time a phase. Yields the mutable field dict so callers can attach
        values known only at its end (bytes, pair counts). ``wait``: a
        torch.device synchronised before the phase's end is read."""
        rng = None
        if _trace_ranges:
            from torch.profiler import record_function

            rng = record_function("slamem:" + name)
            rng.__enter__()
        t0 = time.time_ns()
        try:
            yield fields
        finally:
            if wait is not None:
                from slamem_tpu_torch.utils import device

                device.synchronize(wait)
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


def call_log(enabled: bool) -> PhaseLog:
    """The log an entry point records into: the active one, or (none
    active) a log of the call's own, which prints when ``enabled``."""
    return _active or PhaseLog(enabled=enabled)


def span(name: str, **fields):
    """A phase of the active log (inside an engine call, a stage that
    waits for its device as ``engine_stages`` says); with no log active, a
    context that yields ``fields`` and records nothing."""
    if _active is None:
        return nullcontext(fields)
    return _active.phase(name, wait=_active.stage_wait, **fields)


@contextmanager
def engine_stages(device, verbose: bool):
    """One engine call on ``device``: its ``call_log(verbose)`` is active
    in the region, and every span of the region is a stage, which waits
    for the device at its close when ``verbose`` or a torch profiler runs.
    Yields a dict that holds, once the region ends, the stages' seconds
    summed by name (``stats['stage_s']``)."""
    import torch

    log = call_log(verbose)
    first = len(log.records)
    log.stage_wait = (device if verbose
                      or torch._C._autograd._profiler_enabled() else None)
    stage_s: dict[str, float] = {}
    try:
        with log.activate():
            yield stage_s
    finally:
        log.stage_wait = None
        for rec in log.records[first:]:
            stage_s[rec["phase"]] = (stage_s.get(rec["phase"], 0.0)
                                     + rec["seconds"])


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
