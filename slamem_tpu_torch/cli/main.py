"""slaMEM-compatible command line driver of the PyTorch port (the flags of
``slamem_tpu/cli/main.py`` plus ``-device``).

    slamem-tpu-torch [-mem|-mum|-mam] [-l <minlen>] [-o <outfile>] [-b]
                     [-save <index.npz>] [-load <index.npz>]
                     [-engine scan] [-device cuda|cpu] [-v]
                     <reference.fasta> <query.fasta> [more...]

The options the port does not run yet (-engine seed, -shard, -slabs, -plot)
are parsed as in the JAX package and then refused with exit status 2 and the
ROADMAP item that will bring them.
"""

from __future__ import annotations

import os
import sys

from slamem_tpu_torch.config import Config, MatchMode


class CliError(Exception):
    pass


USAGE = """\
Usage: slamem-tpu-torch [options] <reference.fasta> <query.fasta> [<query2.fasta> ...]
Options:
  -mem          report all maximal exact matches (default)
  -mum          report only matches unique in reference and query
  -mam          report only matches unique in the reference
  -l <n>        minimum match length (default 20)
  -o <file>     output file (default: derived from query file name)
  -b            also search the reverse-complement strand
  -save <file>  save the built index (npz) and exit if no query given
  -load <file>  load a previously saved index instead of rebuilding
  -engine <e>   query engine: seed (default; not ported yet) or scan
  -device <d>   cuda (default) or cpu; cuda without a card is an error
  -sparse <s>   sparse seeding for the seed engine: auto (default) or off
  -v            verbose statistics
Not ported yet (exit status 2): -engine seed, -shard, -slabs <n>, -plot <file>
"""

# option -> the ROADMAP item that ports it
_NOT_PORTED = {
    "-engine seed": "ROADMAP A3: seed frontend and fused tail",
    "-plot": "ROADMAP A6: -plot",
    "-shard": "ROADMAP A8: index sharding",
    "-slabs": "ROADMAP A8: index sharding",
}


def parse_args(argv: list[str]) -> tuple[Config, str, list[str], dict]:
    """argv (no prog name) -> (Config, ref_path, query_paths, extras)."""
    mode = MatchMode.MEM
    min_length = 20
    out_path = None
    both = False
    plot = None
    engine = "seed"
    shard = False
    slabs = None
    sparse = "auto"
    verbose = False
    extras: dict = {"save_index": None, "load_index": None, "device": "cuda"}
    paths: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-mem", "--mem"):
            mode = MatchMode.MEM
        elif a in ("-mum", "--mum"):
            mode = MatchMode.MUM
        elif a in ("-mam", "--mam"):
            mode = MatchMode.MAM
        elif a in ("-l", "--l"):
            i += 1
            if i >= len(argv):
                raise CliError("-l requires a value")
            try:
                min_length = int(argv[i])
            except ValueError:
                raise CliError(f"-l requires an integer, got {argv[i]!r}")
        elif a in ("-o", "--o"):
            i += 1
            if i >= len(argv):
                raise CliError("-o requires a file name")
            out_path = argv[i]
        elif a in ("-b", "--b"):
            both = True
        elif a == "-plot":
            i += 1
            if i >= len(argv):
                raise CliError("-plot requires a file name")
            plot = argv[i]
        elif a == "-save":
            i += 1
            if i >= len(argv):
                raise CliError("-save requires a file name")
            extras["save_index"] = argv[i]
        elif a == "-load":
            i += 1
            if i >= len(argv):
                raise CliError("-load requires a file name")
            extras["load_index"] = argv[i]
        elif a == "-engine":
            i += 1
            if i >= len(argv) or argv[i] not in ("seed", "scan"):
                raise CliError("-engine requires 'seed' or 'scan'")
            engine = argv[i]
        elif a == "-device":
            i += 1
            if i >= len(argv) or argv[i] not in ("cuda", "cpu"):
                raise CliError("-device requires 'cuda' or 'cpu'")
            extras["device"] = argv[i]
        elif a == "-shard":
            shard = True
        elif a == "-slabs":
            i += 1
            if i >= len(argv):
                raise CliError("-slabs requires a value")
            try:
                slabs = int(argv[i])
            except ValueError:
                raise CliError(f"-slabs requires an integer, got {argv[i]!r}")
        elif a == "-sparse":
            i += 1
            if i >= len(argv) or argv[i] not in ("auto", "off"):
                raise CliError("-sparse requires 'auto' or 'off'")
            sparse = argv[i]
        elif a in ("-v", "--verbose"):
            verbose = True
        elif a in ("-h", "--help"):
            raise CliError(USAGE)
        elif a.startswith("-"):
            raise CliError(f"unknown option {a!r}\n{USAGE}")
        else:
            paths.append(a)
        i += 1
    if len(paths) < 1 or (len(paths) < 2 and not extras["save_index"]):
        raise CliError(USAGE)
    try:
        cfg = Config(mode=mode, min_length=min_length, out_path=out_path,
                     both_strands=both, dotplot_path=plot, engine=engine,
                     shard_index=shard, shard_slabs=slabs,
                     sparse_seeds=sparse, verbose=verbose)
    except ValueError as e:
        raise CliError(str(e))
    return cfg, paths[0], paths[1:], extras


def _not_ported(cfg: Config, has_queries: bool) -> str | None:
    """The first requested option the port cannot run yet, as a message."""
    for opt, asked in (("-engine seed", cfg.engine == "seed" and has_queries),
                       ("-plot", cfg.dotplot_path is not None),
                       ("-shard", cfg.shard_index),
                       ("-slabs", cfg.shard_slabs is not None)):
        if asked:
            return f"{opt} is not ported yet ({_NOT_PORTED[opt]})"
    return None


def default_out_path(query_paths: list[str], cfg: Config) -> str:
    """Reference behavior: output name derived from the input names."""
    base = os.path.basename(query_paths[0])
    stem = base.rsplit(".", 1)[0] if "." in base else base
    return f"{stem}-{cfg.mode.value}s.txt"


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        cfg, ref_path, query_paths, extras = parse_args(argv)
    except CliError as e:
        print(str(e), file=sys.stderr)
        return 2
    refused = _not_ported(cfg, bool(query_paths))
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2

    # deferred so -h and refusals stay fast
    import numpy as np

    from slamem_tpu_torch.engine.run import run_engine
    from slamem_tpu_torch.index.build import build_index
    from slamem_tpu_torch.index.serialize import load_index, save_index
    from slamem_tpu_torch.io.fasta import FastaSet, read_fasta
    from slamem_tpu_torch.report.format import format_matches
    from slamem_tpu_torch.utils.device import resolve_device

    device = resolve_device(extras["device"])  # raises if cuda is missing
    try:
        ref_set = read_fasta(ref_path)
        qsets = [read_fasta(p) for p in query_paths]
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    rtext, _ = ref_set.with_separators()

    index = None
    if extras["load_index"]:
        try:
            index = load_index(extras["load_index"], device)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if index.n != len(rtext) + 1 or not np.array_equal(
                index.text[:-1].cpu().numpy(), rtext):
            print("error: loaded index does not match the reference FASTA",
                  file=sys.stderr)
            return 2
    elif extras["save_index"]:
        # otherwise run_engine builds (and times) the index
        index = build_index(rtext, cfg.occ_block, device)
    if extras["save_index"]:
        save_index(extras["save_index"], index)
        if cfg.verbose:
            print(f"index saved to {extras['save_index']}", file=sys.stderr)
        if not query_paths:
            return 0

    # multiple query files concatenate their sequences (reference behavior:
    # extra positional args are more query files)
    if len(qsets) == 1:
        query_set = qsets[0]
    else:
        names = [n for q in qsets for n in q.names]
        lengths = np.concatenate([q.lengths for q in qsets])
        starts = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
        codes = np.concatenate([q.codes for q in qsets])
        query_set = FastaSet(names=names, starts=starts, lengths=lengths,
                             codes=codes)

    try:
        out = run_engine(ref_set, query_set, cfg, device, index=index)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    text = format_matches(out)
    out_path = cfg.out_path or default_out_path(query_paths, cfg)
    if out_path == "-":
        sys.stdout.write(text)
    else:
        with open(out_path, "w") as f:
            f.write(text)
    if cfg.verbose:
        s = out.stats
        print(f"index build: {s['index_build_s']:.3f}s; "
              f"query: {s['query_bp'] / 1e6:.3f} Mbp in {s['query_s']:.3f}s "
              f"({s['query_mbp_per_s']:.2f} Mbp/s); "
              f"matches: {s['matches']}; device: {s['device']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
