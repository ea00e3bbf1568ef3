"""``cli_job``: whole CLI jobs back to back in this process, each
``slamem_tpu_torch.cli.main.main`` over FASTA files that set-up wrote,
with the configuration's ``-l``, the mix's ``cli_args``, and one listing
file that every job writes over."""

from __future__ import annotations

import contextlib
import io
import json
import os
import time

from benchmark.harness.fasta import write_fasta
from benchmark.harness.traffic import Answer, Mix


class Kind(Mix):
    unit = "job"
    prepared = "FASTA files"

    def prepare(self) -> None:
        inp = self.inputs
        self.ref_fa = os.path.join(self.work, "ref.fa")
        self.qry_fa = os.path.join(self.work, "qry.fa")
        self.listing = os.path.join(self.work, "listing.txt")
        write_fasta(self.ref_fa, inp.ref_names, inp.refs)
        write_fasta(self.qry_fa, inp.query_names, inp.queries)
        self.argv = ["-l", str(self.config["min_length"]),
                     *self.traffic.get("cli_args", []),
                     "-device", self.device.type, "-o", self.listing,
                     self.ref_fa, self.qry_fa]

    def answer(self, i: int, traced: bool) -> Answer:
        from slamem_tpu_torch.cli import main as cli

        t0 = time.perf_counter()
        if traced:
            os.environ["SLAMEM_LOG_JSON"] = "1"
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["-v", *self.argv])
        else:
            rc = cli.main(self.argv)
        wall = time.perf_counter() - t0
        size = os.stat(self.listing).st_size if rc == 0 else -1
        if i >= 0 and self.sampled() and rc == 0:
            self.keep(i)
        phases = []
        if traced:
            for line in err.getvalue().splitlines():
                if line.startswith("{"):
                    rec = json.loads(line)
                    if "phase" in rec:
                        phases.append(rec)
        return Answer(wall_s=wall, size=size, bases=self.inputs.query_bases,
                      phases=phases)

    def keep(self, i: int) -> None:
        """Keep job i's listing out of the next job's way."""
        if os.path.exists(self.listing):
            path = os.path.join(self.work, f"kept_{i}.txt")
            os.replace(self.listing, path)
            self.kept_answers[i] = path

    def kept(self) -> dict[int, str]:
        out = {}
        for i, path in self.kept_answers.items():
            with open(path) as f:
                out[i] = f.read()
        return out

    def release(self) -> None:
        pass
