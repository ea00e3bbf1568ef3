"""The general traffic generator. A mix (``benchmark/traffic/<name>.json``)
names its ``kind`` and parameters; the kind is a file of its own,
``benchmark/traffic/kinds/<kind>.py``, whose class ``Kind`` (a ``Mix``)
makes set-up's state and one answer. ``Mix`` runs the window: a closed
loop with one caller.

``check_share`` is the share of answers kept, drawn from the seed, for
the line-by-line comparison; the last answer is always kept, and every
answer's size is compared.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from benchmark.inputs.build import Inputs


@dataclasses.dataclass
class Answer:
    wall_s: float
    size: int                     # bytes of the listing; -1 if it failed
    bases: int                    # query bases searched
    stats: dict | None = None     # run_engine's stats (library_query)
    phases: list[dict] = dataclasses.field(default_factory=list)
    render_s: float | None = None


class Mix:
    """One caller of a mix: ``prepare`` (set-up's files or index),
    ``answer`` (one job or request), the window, and the answers kept for
    the check."""

    def __init__(self, traffic: dict, config: dict, inputs: Inputs,
                 work: str, device: torch.device, seed: int):
        self.traffic = traffic
        self.config = config
        self.inputs = inputs
        self.work = work
        self.device = device
        self.draw = np.random.default_rng([seed % 2**64, 1000])
        self.share = float(traffic["check_share"])
        self.kept_answers: dict[int, str] = {}

    def window(self, seconds: float, traced: bool
               ) -> tuple[list[Answer], float]:
        """Answers until ``seconds`` have passed; the window ends with the
        answer that passes it. Returns (answers, window seconds)."""
        from torch.profiler import record_function

        answers = []
        label = f"bench:{self.unit}"
        t0 = time.perf_counter()
        with (record_function("bench:window") if traced
              else contextlib.nullcontext()):
            while True:
                with (record_function(label) if traced
                      else contextlib.nullcontext()):
                    answers.append(self.answer(len(answers), traced))
                t1 = time.perf_counter()
                if t1 - t0 >= seconds:
                    break
        self.keep(len(answers) - 1)
        return answers, t1 - t0

    def sampled(self) -> bool:
        return self.draw.random() < self.share
