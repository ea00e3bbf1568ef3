"""Frozen run configuration (SURVEY.md §5 "Config / flag system").

The reference (slaMEM) hand-rolls argv parsing in ``main`` and threads ints
through globals; here one frozen dataclass is the single config surface,
populated from the slaMEM-compatible argv parser in ``cli/main.py``
(SURVEY.md §2 CLI surface).
"""

from __future__ import annotations

import dataclasses
import enum


class MatchMode(enum.Enum):
    """Match reporting mode (SURVEY.md §2: -mem / -mum / -mam flags)."""

    MEM = "mem"  # all maximal exact matches (default)
    MUM = "mum"  # matches unique in both reference and query
    MAM = "mam"  # matches unique in the reference


@dataclasses.dataclass(frozen=True)
class Config:
    """All knobs for one engine run.

    CLI-visible fields mirror the reference's surface (SURVEY.md §2):
    mode, min_length (-l), out_path (-o), both_strands (-b). The rest are
    TPU-engine tunables with no reference counterpart.
    """

    mode: MatchMode = MatchMode.MEM
    min_length: int = 20            # -l; reference default 20 (SURVEY §2)
    out_path: str | None = None     # -o; None → derived from input names
    both_strands: bool = False      # -b; also search reverse complement
    dotplot_path: str | None = None  # optional BMP dot-plot (graphics.c parity)

    # --- engine tunables (new; no reference counterpart) ---
    engine: str = "seed"            # "seed" (flagship) or "scan" (survey §3.2)
    # Max seed depth K (engine uses choose_seed_k <= min(min_length, cap)).
    # K <= 16 packs into one uint32 word; 17..32 into two words compared
    # word-lexicographically — still int32-speed (64-bit sort/compare/gather
    # cost 2-6x on v5e). Deeper seeds kill the n*m/4^K random-collision
    # pairs that wall chr-scale queries. See engine/seed_mode.py.
    seed_length_cap: int = 32
    position_block: int = 1 << 26   # max query positions per device dispatch
    pair_capacity: int = 1 << 22    # candidate-pair buffer per dispatch round
    # fallback rounds may grow to this (32M pairs ≈ one round for a chr21
    # strain pair; transient expansion buffers ~10x capacity x 4 B fit HBM)
    pair_capacity_max: int = 1 << 25
    occ_block: int = 128            # occ checkpoint spacing (symbols)
    # scan-engine rank backend (kernels/rank.py): "auto"/"pallas" = the
    # hand-written CUDA kernel on CUDA tensors, its plain version on CPU
    # tensors; "xla" = plain rank_batch over the occ checkpoints;
    # "pallas_interpret" = the plain version over the interleaved table;
    # "nib" (nibble-SWAR layout) is not ported yet
    rank_kernel: str = "auto"
    # seed interval frontend: "auto" = bucket search only when the table
    # dwarfs the query batch (measured crossover n > 64m — prefer_bucket,
    # engine/seed_mode.py), else combined-sort join; "join"/"bucket" force
    # one (A/B tuning surface)
    frontend: str = "auto"
    # MEM run extraction backend: "sort" radix-sorts (diag, qpos) pairs and
    # compacts runs on device (cheapest measured on v5e: a 2-column 32M
    # int32 sort is ~0.15 s while each extra per-pair gather is ~0.4-0.5 s);
    # "boundary" computes character-flag run boundaries during expansion
    # (no pair sort, +4 boundary-char gathers per pair; global flags, so
    # partitioning can never fragment a run). Both are exact and
    # parity-tested; engine/seed_mode.py.
    match_backend: str = "sort"
    # Sparse seeding (MEM mode): sample query seed positions at stride
    # S = min(16, K, L - K + 1) and recover exact match boundaries with a
    # packed-word endpoint extension. Exact for MEMs >= L (proof in
    # engine/seed_mode.py choose_stride) and cuts the candidate-pair axis
    # and the join's query rows by ~S. "auto" = on whenever S >= 2 on the
    # single-device MEM path; "off" forces dense seeding (A/B surface).
    sparse_seeds: str = "auto"
    verbose: bool = False

    # --- distribution (SURVEY §2 "new first-class components") ---
    data_parallel: bool = True      # stream query batches data-parallel
    shard_index: bool = False       # shard FM-index by SA-rank range (config #5)
    # Slab count for -shard, decoupled from the device count (VERDICT r4
    # #1): None = one slab per mesh device (the pod-slice layout); an
    # explicit value > 1 on a SINGLE device runs the true multi-slab
    # program — per-slab tables, slab frontends, per-slab expansion, merge
    # — with slabs iterated on-device (dist/sharded.py virtual slabs), so
    # one chip can execute and validate the config-#5 program at chr1
    # scale. On a real multi-device mesh the value must equal the device
    # count (slabs ride devices there).
    shard_slabs: int | None = None

    def __post_init__(self) -> None:
        if self.min_length < 1:
            raise ValueError(f"min_length must be >= 1, got {self.min_length}")
        if self.shard_slabs is not None and self.shard_slabs < 1:
            raise ValueError(
                f"shard_slabs must be >= 1, got {self.shard_slabs}")
        if not 1 <= self.seed_length_cap <= 32:
            raise ValueError("seed_length_cap must be in [1, 32] (2-bit packing "
                             f"into two uint32 words), got {self.seed_length_cap}")

    @property
    def seed_length(self) -> int:
        """Max seed depth K: min(L, cap). The engine may choose a shallower
        K when one packed word suffices (engine/seed_mode.py choose_seed_k)."""
        return min(self.min_length, self.seed_length_cap)
