"""``library_query``: requests back to back against an index that set-up
built and keeps on the device, each ``run_engine`` with ``index=`` (the
mix's ``config`` adds fields of ``Config``) and ``format_matches``; the
listing text is the answer."""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness.traffic import Answer, Mix


def _fasta_set(names: list[str], seqs: list[np.ndarray]):
    from slamem_tpu_torch.io.fasta import FastaSet

    lengths = np.array([s.size for s in seqs], np.int64)
    return FastaSet(names=list(names),
                    starts=np.concatenate(([0], np.cumsum(lengths)[:-1])),
                    lengths=lengths, codes=np.concatenate(seqs))


class Kind(Mix):
    unit = "request"
    prepared = "index build"

    def prepare(self) -> None:
        from slamem_tpu_torch.config import Config
        from slamem_tpu_torch.index.build import build_index

        inp = self.inputs
        self.ref_set = _fasta_set(inp.ref_names, inp.refs)
        self.query_set = _fasta_set(inp.query_names, inp.queries)
        self.cfg = Config(min_length=int(self.config["min_length"]),
                          **self.traffic.get("config", {}))
        rtext, _ = self.ref_set.with_separators()
        self.index = build_index(rtext, self.cfg.occ_block, self.device)
        self.last = None

    def answer(self, i: int, traced: bool) -> Answer:
        from slamem_tpu_torch.engine import run as engine
        from slamem_tpu_torch.report import format as report

        t0 = time.perf_counter()
        out = engine.run_engine(self.ref_set, self.query_set, self.cfg,
                                index=self.index, device=self.device)
        t1 = time.perf_counter()
        text = report.format_matches(out)
        t2 = time.perf_counter()
        self.last = text
        if i >= 0 and self.sampled():
            self.kept_answers[i] = text
        return Answer(wall_s=t2 - t0, size=len(text),
                      bases=int(out.stats["query_bp"]), stats=out.stats,
                      render_s=t2 - t1)

    def keep(self, i: int) -> None:
        self.kept_answers[i] = self.last

    def kept(self) -> dict[int, str]:
        return self.kept_answers

    def release(self) -> None:
        self.index = None
        self.last = None
