"""Port vs JAX package: the public API.

Every public name of every ``slamem_tpu/`` module (the functions, classes
and constants it defines, read from its source with ``ast``, and the names
an ``__init__.py`` re-exports) must exist in the port's module of the same
path, or stand in a table below with its counterpart or its reason. For
each function both packages define, every JAX parameter must exist in the
port by name or stand in a table with its reason; a parameter the port adds
has a default unless the function is listed as internal. Then the names
this layer of the port added are held to the JAX ones on inputs made from
seeds with numpy: the index-level rank drop-ins (``rank_pallas`` against the
Pallas kernel in interpret mode, ``rank_nib`` at several row widths,
``rank_xla``), ``backward_step`` (also against a naive count), the io
re-exports and ``str_to_codes``, ``write_matches`` and
``format_matches(force=)``, the entry points' default device, and
``find_scan_matches`` on a one-rank mesh. Tolerance: exact — counts,
intervals, codes, match tuples and listing bytes are integers or bytes and
must be equal.
"""

import ast
import inspect
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slamem_tpu
import slamem_tpu.io as jax_io
from slamem_tpu.config import Config as JaxConfig
from slamem_tpu.dist import mesh as jmesh
from slamem_tpu.engine import scan_mode as jscan
from slamem_tpu.engine.run import EngineOutput as JaxOutput
from slamem_tpu.engine.run import QueryMatches as JaxQueryMatches
from slamem_tpu.index.build import backward_step as jax_backward_step
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.index.build import rank_batch as jax_rank_batch
from slamem_tpu.kernels import rank as jrank
from slamem_tpu.report.format import format_matches as jax_format
from slamem_tpu.report.format import write_matches as jax_write_matches
from slamem_tpu.utils.synth import mutate, random_genome, with_n_runs

import slamem_tpu_torch
import slamem_tpu_torch.io as port_io
from slamem_tpu_torch._native import matchfmt
from slamem_tpu_torch.config import Config
from slamem_tpu_torch.dist.mesh import make_mesh
from slamem_tpu_torch.engine import run as port_run
from slamem_tpu_torch.engine.run import EngineOutput, QueryMatches
from slamem_tpu_torch.engine.scan_mode import find_scan_matches
from slamem_tpu_torch.index import serialize
from slamem_tpu_torch.index.build import backward_step, build_index
from slamem_tpu_torch.index.build import rank_batch
from slamem_tpu_torch.index.serialize import index_from_numpy
from slamem_tpu_torch.io.fasta import read_fasta, str_to_codes
from slamem_tpu_torch.kernels import rank
from slamem_tpu_torch.report.format import format_matches, write_matches

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "slamem_tpu"
PORT_ROOT = REPO / "slamem_tpu_torch"
_FIELDS = ("text", "sa", "bwt", "occ_ckpt", "counts")

A11 = "not ported by design (ROADMAP A11): the port sizes buffers from data"
PALLAS = ("Pallas tiling (GSIZE x TILE query blocks); the CUDA kernel "
          "takes one warp a query")
INTERPRET = "Pallas interpret mode: the CPU device plays that part"
UNPADDED = ("the port's blocks take the intervals unpadded and a block "
            "[start, end) of them (no capacity-wide slices: A11)")

# JAX modules with no port module
NOT_PORTED_MODULES = {
    "engine/adaptive.py": A11,
    "utils/devcache.py": A11,
}

# JAX names whose port counterpart has another name: (module, name) ->
# (port module, port name)
RENAMED = {
    ("engine/seed_mode.py", "packed_kmers"):
        ("engine/seed_mode.py", "packed_key_words"),
    ("engine/seed_mode.py", "sampled_query_keys"):
        ("engine/seed_mode.py", "packed_key_words"),
    ("engine/seed_mode.py", "query_frontend"):
        ("engine/seed_mode.py", "seed_intervals"),
    ("engine/seed_mode.py", "lex_searchsorted"):
        ("engine/seed_mode.py", "seed_intervals"),
    ("engine/seed_mode.py", "query_frontend_bucket"):
        ("engine/seed_mode.py", "_bucket_intervals"),
    ("dist/sharded.py", "shard_tables"):
        ("dist/sharded.py", "mesh_slab_tables"),
    ("dist/sharded.py", "sharded_frontend"):
        ("dist/sharded.py", "mesh_frontend"),
    ("dist/sharded.py", "sharded_frontend_join"):
        ("dist/sharded.py", "mesh_frontend"),
    ("kernels/rank.py", "rank_rows_xla"):
        ("kernels/rank.py", "rank_rows_plain"),
}

# JAX names with no port counterpart: (module, name) -> reason
NO_COUNTERPART = {
    ("kernels/rank.py", "rank_rows_padded"): PALLAS,
    ("kernels/rank.py", "GSIZE"): PALLAS,
    ("kernels/rank.py", "TILE"): PALLAS,
    ("dist/mesh.py", "replicated"):
        "JAX sharding helper: every process holds its own copy of the index",
    ("dist/mesh.py", "row_sharded"):
        "JAX sharding helper: every process holds its own copy of the index",
    ("dist/mesh.py", "put_replicated"):
        "JAX sharding helper: every process holds its own copy of the index",
    **{("engine/seed_mode.py", n): A11 for n in (
        "fused_query", "fused_query_bucket", "FusedPlan",
        "runs_from_compacted32", "query_ext_table", "capacity_bucket",
        "plan_blocks_on_device", "seed_last_from_disk")},
    ("index/build.py", "index_digest"): A11 + " (the adaptive store's key)",
    ("index/build.py", "register_digest"): A11 + " (the adaptive store's key)",
    ("index/build.py", "initial_ranks"):
        "nothing starts prefix doubling from 1-character ranks: the suffix "
        "sort starts from 27-character window keys (sa_keys) and the LCP "
        "array compares suffixes directly (index/lcp.py)",
    ("utils/pack2.py", "spec_bucket"): A11 + " (the side channel is exact)",
    ("utils/log.py", "V5E_HBM_GBPS"):
        "no rate is derived from a phase's bytes: bytes over a host-timed "
        "phase against a constant is no device rate (the query record "
        "keeps its roofline bytes)",
    ("utils/log.py", "NULL_LOG"):
        "run_engine logs into the active log or a log of its own call, so "
        "stats['phases'] holds only that call's records",
}

# parameters the JAX package takes in every function that has them
COMMON_PARAMS = {
    "capacity": A11, "run_capacity": A11, "block": A11,
    "interpret": INTERPRET,
}

# JAX parameters the port does not take: (module, function) -> {param:
# reason}
PARAM_REASONS = {
    ("_native/matchfmt.py", "render_multi"): {
        "name_w": "format_matches pads the names by characters, so the C "
                  "renderer copies them whole and needs no width"},
    ("dist/mesh.py", "make_mesh"): {
        "axis": "a mesh is the process group's world, with one axis"},
    ("dist/seed.py", "expand_runs_gathered"): dict.fromkeys(
        ("lo_ext", "w_ext", "starts", "limits"), UNPADDED),
    ("dist/seed.py", "expand_boundaries_gathered"): dict.fromkeys(
        ("lo_ext", "w_ext", "starts", "limits"), UNPADDED),
    ("dist/seed.py", "full_query_step"): {
        "qpos0": "the block's first sample is the int q_start"},
    ("dist/sharded.py", "sharded_expand_runs"): {
        "sa_sh": "each rank takes its own slab, sa_i",
        "lo_sh": "each rank takes its own slab's intervals, lo",
        "w_sh": "each rank takes its own slab's intervals, w",
        "limit": UNPADDED},
    ("dist/sharded.py", "virtual_expand_runs"): {
        "limit": UNPADDED,
        "n_slabs": "the slabs to expand are listed, slabs"},
    ("dist/sharded.py", "merge_slab_runs"): {
        "n_runs": "fragments are exact-size tensors (A11)",
        "out_cap": A11},
    ("engine/seed_mode.py", "extend_runs"): {
        "n_runs": "runs are exact-size tensors (A11)",
        "ext_q": "the kernel reads the query text (q_text) itself"},
    **{("engine/seed_mode.py", f): {"lo_full": UNPADDED, "w_full": UNPADDED,
                                    "limit": UNPADDED}
       for f in ("expand_block_to_boundaries", "expand_block_to_runs",
                 "expand_block_pairs")},
    ("engine/seed_mode.py", "plan_fused"): {
        "query_text": "it seeded the adaptive store (A11)"},
    ("engine/seed_mode.py", "pairs_to_matches"): {
        "cum": "rounds are planned from one read of the pair total",
        "summary": "rounds are planned from one read of the pair total",
        "ext_r": "the extension kernel reads the reference text itself",
        "frontend": "it fed the fused dispatch (A11)"},
    ("engine/seed_mode.py", "finalize_matches"): {
        "batches": "the boundary backend hands one merged RunBatch, runs"},
}

# port functions whose added parameters need no default: steps inside the
# engines, called with every argument by the port itself
INTERNAL = {
    ("dist/seed.py", "expand_runs_gathered"),
    ("dist/seed.py", "expand_boundaries_gathered"),
    ("dist/seed.py", "full_query_step"),
    ("dist/sharded.py", "sharded_expand_runs"),
    ("dist/sharded.py", "virtual_expand_runs"),
    ("engine/seed_mode.py", "extend_runs"),
    ("engine/seed_mode.py", "expand_block_to_boundaries"),
    ("engine/seed_mode.py", "expand_block_to_runs"),
    ("engine/seed_mode.py", "expand_block_pairs"),
    ("engine/seed_mode.py", "query_to_device"),
    ("engine/seed_mode.py", "finalize_matches"),
    ("utils/pack2.py", "codes_to_device"),
}


def _public(path: Path) -> dict:
    """Public top-level names of a module's source: name -> its
    ``ast.arguments`` for a function, None for a class, a constant or (in
    an ``__init__.py``) a re-exported name."""
    names = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = node.args
        elif isinstance(node, ast.ClassDef):
            names[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update((t.id, None) for t in targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update((a.asname or a.name, None) for a in node.names)
    return {k: v for k, v in names.items() if not k.startswith("_")}


def _params(args: ast.arguments) -> dict:
    """Parameter name -> whether it has a default."""
    pos = args.posonlyargs + args.args
    out = {a.arg: i >= len(pos) - len(args.defaults)
           for i, a in enumerate(pos)}
    out.update((a.arg, d is not None)
               for a, d in zip(args.kwonlyargs, args.kw_defaults))
    return out


JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT))
                     for p in JAX_ROOT.rglob("*.py"))


def _both(module: str) -> tuple[dict, dict]:
    return _public(JAX_ROOT / module), _public(PORT_ROOT / module)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    """A JAX module's public names exist in the port's module of the same
    path, under another name (RENAMED) or not at all with a reason
    (NO_COUNTERPART, NOT_PORTED_MODULES)."""
    if module in NOT_PORTED_MODULES:
        assert not (PORT_ROOT / module).exists()
        return
    jax_names, port_names = _both(module)
    missing = [n for n in jax_names if n not in port_names
               and (module, n) not in RENAMED
               and (module, n) not in NO_COUNTERPART]
    assert not missing, f"{module}: no counterpart for {missing}"


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_parameter_has_a_counterpart(module):
    """For each function of both packages: every JAX parameter exists in
    the port or has its reason; a parameter the port adds has a default
    unless the function is INTERNAL."""
    if module in NOT_PORTED_MODULES:
        return
    jax_names, port_names = _both(module)
    bad = []
    for name, jargs in jax_names.items():
        pargs = port_names.get(name)
        if jargs is None or pargs is None:
            continue
        jp, pp = _params(jargs), _params(pargs)
        reasons = {**COMMON_PARAMS, **PARAM_REASONS.get((module, name), {})}
        bad += [f"{name}({p}) missing" for p in jp
                if p not in pp and p not in reasons]
        if (module, name) not in INTERNAL:
            bad += [f"{name}({p}) added without a default" for p, d in
                    pp.items() if p not in jp and not d]
    assert not bad, f"{module}: {bad}"


def test_tables_name_real_code():
    """Every entry of the tables names a JAX name or parameter that exists
    and that the port lacks; every RENAMED counterpart exists in the port;
    every INTERNAL function exists in both packages."""
    for module in NOT_PORTED_MODULES:
        assert (JAX_ROOT / module).exists(), module
    for (module, name), (pmod, pname) in RENAMED.items():
        jax_names, port_names = _both(module)
        assert name in jax_names and name not in port_names, (module, name)
        assert pname in _public(PORT_ROOT / pmod) or re.search(
            rf"^def {pname}\b", (PORT_ROOT / pmod).read_text(), re.M), pname
    for module, name in NO_COUNTERPART:
        jax_names, port_names = _both(module)
        assert name in jax_names and name not in port_names, (module, name)
    for (module, name), params in PARAM_REASONS.items():
        jax_names, port_names = _both(module)
        jp, pp = _params(jax_names[name]), _params(port_names[name])
        for p in params:
            assert p in jp and p not in pp, (module, name, p)
    for module, name in INTERNAL:
        jax_names, port_names = _both(module)
        assert jax_names[name] is not None and port_names[name] is not None


def _pair(t, occ_block=128):
    jidx = jax_build(t, occ_block=occ_block)
    return jidx, index_from_numpy({f: np.asarray(getattr(jidx, f))
                                   for f in _FIELDS}, occ_block, "cpu")


@pytest.fixture(scope="module")
def indexes():
    """tests/test_rank_kernel.py's nibble input: 60 kbp with N runs."""
    t = with_n_runs(random_genome(60_000, seed=71), 3, 25, seed=72)
    return _pair(t)


def _queries(seed: int, b: int, n: int, per_row: int, span: int):
    """b random (c, j), j in [0, n], then every row edge (each row start,
    its neighbours, the middle), n - 1, n and the table's last position,
    each with every char."""
    rng = np.random.default_rng(seed)
    starts = np.arange(0, span, per_row)
    edge = np.unique(np.clip(np.concatenate(
        [starts, starts + 1, starts - 1, starts + per_row // 2,
         [0, 1, n - 1, n, span - 1]]), 0, span - 1))
    pos = np.concatenate([rng.integers(0, n + 1, b), np.repeat(edge, 4)])
    chars = np.concatenate([rng.integers(0, 4, b),
                            np.tile(np.arange(4), edge.size)])
    return chars.astype(np.int32), pos.astype(np.int32)


def test_rank_pallas_and_rank_xla_equal_jax(indexes):
    """rank_pallas == the JAX Pallas kernel in interpret mode, rank_xla ==
    JAX rank_xla, both == rank_batch, on random queries and the
    interleaved table's row edges; both take int64 queries as rank_batch
    does."""
    jidx, tidx = indexes
    span = rank.interleaved_rows(tidx).shape[0] * rank.SYMS_PER_ROW
    chars, pos = _queries(140, 2048, jidx.n, rank.SYMS_PER_ROW, span)
    jc, jp = jnp.asarray(chars), jnp.asarray(pos)
    want = np.asarray(jrank.rank_pallas(jidx, jc, jp, interpret=True))
    assert np.array_equal(want, np.asarray(jrank.rank_xla(jidx, jc, jp)))
    c, p = torch.from_numpy(chars), torch.from_numpy(pos)
    before = rank.rank_rows.launches
    for fn in (rank.rank_pallas, rank.rank_xla):
        got = fn(tidx, c, p)
        assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
        assert np.array_equal(want, fn(tidx, c.long(), p.long()).numpy())
    assert rank.rank_rows.launches == before   # CPU: the plain versions
    inside = pos <= jidx.n
    assert np.array_equal(want[inside], rank_batch(
        tidx, c[inside], p[inside]).numpy())
    assert np.array_equal(want[inside], np.asarray(jax_rank_batch(
        jidx, jc[inside], jp[inside])))


@pytest.mark.parametrize("row_words", [128, 512, 2048, 130])
def test_rank_nib_equals_jax_at_every_width(indexes, row_words):
    """rank_nib at row_words == JAX rank_nib at the same width, on random
    queries and every row edge of that table; its table == the JAX
    nibble_rows bit for bit, built once per width; == rank_batch inside
    [0, n]."""
    jidx, tidx = indexes
    rows = rank.nibble_rows(tidx, row_words)
    want_rows = np.asarray(jrank.nibble_rows(jidx, row_words))
    assert rows.shape == (tidx.n // rank._nib_per_row(row_words) + 1,
                          row_words)
    assert np.array_equal(want_rows.view(np.uint32),
                          rows.numpy().view(np.uint32))
    assert rank.nibble_rows(tidx, row_words) is rows
    assert (rank.nibble_rows(tidx) is rows) == (row_words == 128)
    per_row = rank._nib_per_row(row_words)
    chars, pos = _queries(row_words, 2048, jidx.n, per_row,
                          rows.shape[0] * per_row)
    want = np.asarray(jrank.rank_nib(jidx, jnp.asarray(chars),
                                     jnp.asarray(pos), row_words=row_words))
    c, p = torch.from_numpy(chars), torch.from_numpy(pos)
    got = rank.rank_nib(tidx, c, p, row_words=row_words)
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
    assert np.array_equal(want, rank.rank_rows_nib(rows, c, p).numpy())
    inside = pos <= jidx.n
    assert np.array_equal(want[inside], rank_batch(
        tidx, c[inside], p[inside]).numpy())


@pytest.mark.parametrize("row_words", [4, 3, 0, 2**28 + 5])
def test_nibble_widths_outside_the_range_are_refused(row_words):
    with pytest.raises(ValueError, match="row_words"):
        rank._build_rows_nib(torch.zeros(10, dtype=torch.uint8), row_words)


def _naive_count(text: np.ndarray, pat: np.ndarray) -> int:
    win = np.lib.stride_tricks.sliding_window_view(text, len(pat))
    return int(np.all(win == pat, axis=1).sum())


@pytest.mark.parametrize("seed, n, occ_block", [(0, 700, 8), (1, 3000, 128),
                                                (2, 20_000, 64)])
def test_backward_step_equals_jax_and_naive(seed, n, occ_block):
    """tests/test_index.py's backward search, batched: random texts with
    N and SEP, patterns of lengths 1..12, planted or random; every step's
    (lo, hi) == the JAX backward_step's, and the final width == the naive
    count of the pattern's occurrences."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, n).astype(np.uint8)
    t[rng.integers(0, n, n // 12)] = 4
    t[rng.integers(0, n, n // 20)] = 5
    jidx, tidx = _pair(t, occ_block)
    plen = 12
    pats = rng.integers(0, 4, (64, plen)).astype(np.int32)
    for i in range(0, 64, 2):      # half planted: guaranteed hits
        while True:
            s = int(rng.integers(0, n - plen))
            if (t[s:s + plen] < 4).all():
                break
        pats[i] = t[s:s + plen]
    lo = torch.zeros(64, dtype=torch.int32)
    hi = torch.full((64,), jidx.n, dtype=torch.int32)
    jlo, jhi = jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())
    for d in range(plen - 1, -1, -1):   # right to left
        c = pats[:, d]
        lo, hi = backward_step(tidx, torch.from_numpy(c), lo, hi)
        jlo, jhi = jax_backward_step(jidx, jnp.asarray(c), jlo, jhi)
        assert np.array_equal(lo.numpy(), np.asarray(jlo))
        assert np.array_equal(hi.numpy(), np.asarray(jhi))
        for k in range(0, 64, 7):
            assert int(hi[k] - lo[k]) == _naive_count(t, pats[k, d:])
    assert ((hi - lo)[::2] > 0).all()


def test_io_reexports_and_str_to_codes():
    """slamem_tpu_torch.io re-exports the JAX package's io names from the
    port's own fasta module; str_to_codes == the JAX one on every byte a
    sequence may hold; Config and MatchMode come from the package root."""
    from slamem_tpu_torch.io import fasta

    for name in [a.asname or a.name for node in ast.parse(
            (JAX_ROOT / "io" / "__init__.py").read_text()).body
            if isinstance(node, ast.ImportFrom) for a in node.names]:
        assert getattr(port_io, name) is getattr(fasta, name), name
    assert slamem_tpu_torch.Config is Config
    assert [m.value for m in slamem_tpu_torch.MatchMode] == [
        m.value for m in slamem_tpu.MatchMode]
    text = bytes(range(32, 127)).decode("ascii") * 3
    rng = np.random.default_rng(7)
    text += "".join(rng.choice(list("ACGTacgtNnRY"), 500))
    got = str_to_codes(text)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jax_io.str_to_codes(text))
    assert np.array_equal(port_io.codes_to_str(got[-500:]),
                          jax_io.codes_to_str(got[-500:]))


def _outputs(multi: bool, names=("chrA", "chrB_long", "c")):
    """The same listing as a JAX and a port EngineOutput, from numpy."""
    rng = np.random.default_rng(11 + multi)
    refs = list(names if multi else names[:1])
    per = []
    for qi, rev in ((0, False), (0, True), (1, False)):
        k = int(rng.integers(0, 40))
        f = dict(query_name=f"q{qi}", reverse=rev,
                 ref_seq=rng.integers(0, len(refs), k),
                 ref_pos=rng.integers(0, 10**7, k),
                 q_pos=rng.integers(0, 10**6, k),
                 length=rng.integers(20, 10**4, k))
        per.append(f)
    return (JaxOutput(refs, [JaxQueryMatches(**f) for f in per], {}),
            EngineOutput(refs, [QueryMatches(**f) for f in per], {}))


@pytest.mark.parametrize("multi", [False, True])
def test_write_matches_bytes_equal_jax(tmp_path, multi):
    jout, tout = _outputs(multi)
    jax_write_matches(str(tmp_path / "j.txt"), jout)
    write_matches(str(tmp_path / "t.txt"), tout)
    want = (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t.txt").read_bytes() == want
    assert want.count(b"\n") > 20


@pytest.mark.parametrize("force", [None, "native", "python", "other"])
@pytest.mark.parametrize("names", [("chrA", "chrB_long", "c"),
                                   ("chré", "b", "üü")])
def test_format_matches_force_equals_jax(force, names, monkeypatch):
    """format_matches(force=...) renders the JAX listing's characters by
    the renderer asked for (None, "native": C; any other value: Python),
    non-ASCII names included; forcing the C renderer where it cannot be
    built raises, as the JAX package does."""
    jout, tout = _outputs(True, names)
    want = jax_format(jout, force="python")
    assert format_matches(tout, force=force) == want
    native = []
    with monkeypatch.context() as m:
        m.setattr(matchfmt, "render_multi",
                  lambda *a: native.append(1) or b"")
        format_matches(tout, force=force)
    assert bool(native) == (force in (None, "native"))

    def no_library():
        raise RuntimeError("gcc failed")

    monkeypatch.setattr(matchfmt, "_lib", no_library)
    if force in (None, "native"):
        with pytest.raises(RuntimeError, match="gcc"):
            format_matches(tout, force=force)
    else:
        assert format_matches(tout, force=force) == want


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """run_engine, load_index and build_index take the JAX parameters in
    the JAX order, with ``device`` a keyword defaulting to the card; called
    without it where there is no card, they raise (nothing drops to the
    CPU on its own); with device="cpu" they run."""
    for fn, jax_params in (
            (port_run.run_engine,
             ["ref_set", "query_set", "cfg", "index", "mesh"]),
            (serialize.load_index, ["path"]),
            (build_index, ["text", "occ_block"])):
        params = inspect.signature(fn).parameters
        assert list(params)[:len(jax_params)] == jax_params
        assert params["device"].default == "cuda"
    ref = with_n_runs(random_genome(3000, seed=31), 2, 20, seed=32)
    qry = mutate(ref, 0.02, 0.002, seed=33)
    from slamem_tpu_torch.io.fasta import Sequence, write_fasta

    write_fasta(str(tmp_path / "r.fa"), [Sequence("r", ref)])
    write_fasta(str(tmp_path / "q.fa"), [Sequence("q", qry)])
    rs, qs = read_fasta(tmp_path / "r.fa"), read_fasta(tmp_path / "q.fa")
    idx = build_index(rs.with_separators()[0], device="cpu")
    serialize.save_index(str(tmp_path / "i.npz"), idx)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_run.run_engine(rs, qs, Config(min_length=20))
    with pytest.raises(RuntimeError, match="cuda"):
        serialize.load_index(str(tmp_path / "i.npz"))
    with pytest.raises(RuntimeError, match="cuda"):
        build_index(ref)
    loaded = serialize.load_index(str(tmp_path / "i.npz"), device="cpu")
    out = port_run.run_engine(rs, qs, Config(min_length=20), loaded, None,
                              device="cpu")
    assert out.stats["device"] == "cpu" and out.stats["matches"] > 0


def test_find_scan_matches_on_a_one_rank_mesh_equals_jax():
    """find_scan_matches(..., mesh) hands the mesh to the shared backend as
    the JAX function does: on one-rank meshes of both packages the match
    tuples are equal, and equal the meshless call's."""
    ref = with_n_runs(random_genome(4000, seed=41), 2, 30, seed=42)
    qry = with_n_runs(mutate(ref, 0.02, 0.002, seed=43), 2, 20, seed=44)
    jidx, tidx = _pair(ref)
    got = find_scan_matches(tidx, qry, Config(min_length=14, engine="scan"),
                            mesh=make_mesh(1, "cpu"))
    jm = jscan.find_scan_matches(jidx, qry, JaxConfig(min_length=14,
                                                      engine="scan"),
                                 mesh=jmesh.make_mesh(1))
    none = find_scan_matches(tidx, qry, Config(min_length=14, engine="scan"))

    def tuples(m):
        return sorted(zip(m.refpos.tolist(), m.qpos.tolist(),
                          m.length.tolist()))

    assert tuples(got) == tuples(jm) == tuples(none)
    assert len(tuples(got)) > 10


def test_demo_twin_uses_the_port_alone():
    """examples/demo_torch.py imports only the port's names (no jax, no
    JAX package) and makes the JAX demo's calls without a device."""
    src = (REPO / "examples" / "demo_torch.py").read_text()
    assert not re.search(r"^\s*(?:import|from)\s+(?:jax|jaxlib|slamem_tpu)"
                         r"\b(?!_torch)", src, re.M)
    assert "device" not in src
    for call in ("run_engine(ref_set, q_set, cfg)", "load_index(path)",
                 "run_engine(ref_set, q_set, cfg, index=index2)",
                 "shard_slabs=4"):
        assert call in src, call
    assert os.path.exists(REPO / "examples" / "demo.py")
