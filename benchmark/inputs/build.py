"""A configuration's inputs from the run's seed.

A configuration file (``benchmark/configs/<name>.json``) names the recipe:
one reference sequence of ``reference_length`` random bases, and one query
entry per item of ``query_entries``, a diverged copy of the reference
(``sub_rate``, ``indel_rate``) cut to its first ``query_length`` bases
where that is set. Stream 0 makes the reference,
stream j + 1 query entry j.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.inputs import synth


@dataclasses.dataclass
class Inputs:
    ref_names: list[str]
    refs: list[np.ndarray]        # uint8 codes, one array a sequence
    query_names: list[str]
    queries: list[np.ndarray]

    @property
    def query_bases(self) -> int:
        return int(sum(q.size for q in self.queries))


def make_inputs(config: dict, seed: int, device: torch.device) -> Inputs:
    gen = synth.generator(seed, 0, device)
    ref = synth.random_genome(int(config["reference_length"]), gen)
    cut = config.get("query_length")
    names, queries = [], []
    for j, entry in enumerate(config["query_entries"]):
        q = synth.mutate(ref, entry["sub_rate"], entry["indel_rate"],
                         synth.generator(seed, j + 1, device))
        names.append(entry["name"])
        queries.append((q[:cut] if cut else q).cpu().numpy())
        del q
    return Inputs(ref_names=[config["reference_name"]],
                  refs=[ref.cpu().numpy()], query_names=names,
                  queries=queries)
