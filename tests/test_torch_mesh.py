"""Port vs JAX package: the multi-device mesh (``slamem_tpu_torch.dist``:
the replicated data-parallel path, the one-slab-per-rank sharded path and
``full_query_step``) over gloo on the CPU.

The ranks are child processes, one per rank (``RUNNER`` below, run with
``sys.executable -c``), joined by the JAX package's launcher variables as
the CLI joins them. Every rank saves what it computed; the test holds each
rank's result to every other rank's, to the port's single-device and
virtual-slab engines, and to the JAX package's mesh on conftest's fake CPU
devices (``make_mesh(w)``), on the inputs of tests/test_dist.py and
tests/test_sharded.py. A one-rank gloo group in this process runs the
mesh branches at world size 1. Tolerance: exact — intervals, run triples
and match tuples are integers and must be equal.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from slamem_tpu.config import Config as JaxConfig
from slamem_tpu.config import MatchMode as JaxMode
from slamem_tpu.dist import mesh as jmesh
from slamem_tpu.dist import sharded as jsh
from slamem_tpu.engine import seed_mode as jseed
from slamem_tpu.index.build import build_index as jax_build
from slamem_tpu.utils.synth import mutate, random_genome, with_n_runs

from slamem_tpu_torch.config import Config, MatchMode
from slamem_tpu_torch.dist import mesh, seed, sharded
from slamem_tpu_torch.engine import seed_mode
from slamem_tpu_torch.index.serialize import index_from_numpy

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIELDS = ("text", "sa", "bwt", "occ_ckpt", "counts")
_TIMEOUT_S = 120

# One rank: argv = job file. Runs every job of the file on the mesh of all
# ranks and saves its results to <out>.<rank>.npz.
RUNNER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from slamem_tpu_torch.config import Config, MatchMode
from slamem_tpu_torch.dist import mesh as M, seed, sharded
from slamem_tpu_torch.engine import seed_mode
from slamem_tpu_torch.index.build import build_index

job = json.load(open(sys.argv[1]))
data = np.load(job["inputs"])
M.initialize_multihost("cpu", timeout_s=60)
mesh = M.make_mesh(device="cpu")
res = {}
indexes = {}
for j in job["jobs"]:
    name, ref, qry = j["name"], data[j["ref"]], data[j["qry"]]
    if j["ref"] not in indexes:
        indexes[j["ref"]] = build_index(ref, device="cpu")
    index = indexes[j["ref"]]
    cfg = Config(**j["cfg"])
    if j["kind"] == "frontend":
        k, stride, _ = seed_mode.choose_seed_plan(index.n, len(qry), cfg)
        t = sharded.mesh_slab_tables(index, k, mesh)
        qt = torch.from_numpy(qry)
        got = sharded.mesh_frontend(mesh, t[0], t[2], t[3], t[4], qt, t[7],
                                    k, t[5], t[6], stride)
        for key, a in zip(("lo", "w", "cum", "summary"), got):
            res[f"{name}/{key}"] = a.numpy()
        res[f"{name}/plan"] = np.array([k, stride, t[5], t[6], t[7]])
        continue
    if j["kind"] == "full_query_step":
        k, w = j["k"], mesh.size
        qk, qv = seed_mode.packed_key_words(torch.from_numpy(qry), k)
        refk, sa_aug = seed_mode.seed_table(index, k)
        block = -(-qk.shape[0] // w)
        a = mesh.rank * block
        runs, counts, total = seed.full_query_step(
            mesh, refk, sa_aug, qk[a:a + block], qv[a:a + block], a,
            j["m_off"])
        res[f"{name}/runs"] = runs.numpy()
        res[f"{name}/counts"] = np.array(counts)
        res[f"{name}/total"] = np.array(int(total))
        continue
    if j["kind"] == "sharded":
        m = sharded.find_seed_matches_sharded(index, qry, cfg, mesh)
    else:
        m = seed_mode.find_seed_matches(index, qry, cfg, mesh)
    for mode in j["modes"]:
        f = seed_mode.apply_mode_filter(m, Config(**j["cfg"],
                                                  mode=MatchMode(mode)))
        res[f"{name}/{mode}"] = np.stack([f.refpos, f.qpos, f.length], 1)
    res[f"{name}/stats"] = np.array([m.stats["rounds"], m.stats["pairs"],
                                     m.stats["k"], m.stats["stride"]])
np.savez(job["out"] + f".{mesh.rank}.npz", **res)
"""


@contextlib.contextmanager
def _reserved_port():
    """A free port, held for the ``with`` block by a socket bound to it
    with SO_REUSEADDR and not listening. While it is held, no bind to port
    0 in any process (another test's free port, a gloo or JAX listener) is
    handed it, so no other world's rank can join this world's store or
    take its port; rank 0's store, which binds with SO_REUSEADDR, can
    still bind and listen on it."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        yield s.getsockname()[1]


def rank_env(port: int, world: int, rank: int) -> dict:
    """The environment of one rank: the JAX package's launcher variables,
    the repo on the path, one thread."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank),
               PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def run_ranks(argvs: list[list[str]], timeout: float = _TIMEOUT_S):
    """Start one process per argv (rank = position) joined as one world on
    a port reserved until every rank has ended; returns [(returncode,
    stderr)] per rank. A world that outlives ``timeout`` is killed and
    fails the test. A world whose port another process chose before it
    was reserved and then listened on (EADDRINUSE at rank 0's bind) is
    started once more on another port."""
    for attempt in range(2):
        with _reserved_port() as port:
            procs = [subprocess.Popen(argv, cwd=REPO,
                                      env=rank_env(port, len(argvs), r),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for r, argv in enumerate(argvs)]
            out = []
            try:
                for p in procs:
                    _, err = p.communicate(timeout=timeout)
                    out.append((p.returncode, err))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
        if not any("EADDRINUSE" in err for _, err in out):
            break
    return out


def _tuples(m):
    return sorted(zip(m.refpos.tolist(), m.qpos.tolist(), m.length.tolist()))


def _rows(a):
    return sorted(map(tuple, np.asarray(a).tolist()))


def _port_index(jidx):
    return index_from_numpy({f: np.asarray(getattr(jidx, f))
                             for f in _FIELDS}, jidx.occ_block, "cpu")


def _repeat_pair():
    """tests/test_sharded.py's MUM/MAM input: a tandem duplication makes
    some MEMs non-unique."""
    ref = with_n_runs(random_genome(3000, seed=86), 2, 30, seed=87)
    ref = np.concatenate([ref, ref[500:900]])
    return ref, with_n_runs(mutate(ref, 0.02, 0.002, seed=88), 2, 20,
                            seed=89)


INPUTS = {
    # tests/test_dist.py: several groups, a block count not a multiple of w
    "rep": (random_genome(3000, seed=51),
            mutate(random_genome(3000, seed=51), 0.02, 0.002, seed=52)),
    # one run that crosses every block
    "cross": (random_genome(1200, seed=53), random_genome(1200, seed=53)),
    # tests/test_sharded.py
    "shard": (with_n_runs(random_genome(4000, seed=81), 2, 40, seed=82),
              with_n_runs(mutate(with_n_runs(random_genome(4000, seed=81),
                                             2, 40, seed=82),
                                 0.02, 0.002, seed=83), 2, 30, seed=84)),
    "repeat": _repeat_pair(),
}
REP = dict(min_length=12, pair_capacity=256, position_block=100)
MODES = ("mem", "mum", "mam")
# name -> (kind, input, Config fields, modes)
JOBS = {
    "rep_sparse": ("replicated", "rep", REP, ("mem",)),
    "rep_dense": ("replicated", "rep", {**REP, "sparse_seeds": "off"},
                  ("mem",)),
    "rep_boundary": ("replicated", "rep", {**REP, "match_backend":
                                           "boundary"}, ("mem",)),
    "rep_modes": ("replicated", "repeat", dict(min_length=14,
                                              pair_capacity=512), MODES),
    "cross": ("replicated", "cross", dict(min_length=1000, pair_capacity=64,
                                          position_block=29), ("mem",)),
    "shard_sparse": ("sharded", "shard", dict(min_length=14,
                                              pair_capacity=512), ("mem",)),
    "shard_dense": ("sharded", "shard", dict(min_length=14,
                                             sparse_seeds="off"), ("mem",)),
    "shard_rounds": ("sharded", "shard", dict(min_length=14,
                                              pair_capacity=100), ("mem",)),
    "shard_modes": ("sharded", "repeat", dict(min_length=14,
                                             pair_capacity=512), MODES),
    "shard_cross": ("sharded", "cross", dict(min_length=1000), ("mem",)),
    "front_sparse": ("frontend", "shard", dict(min_length=14), ()),
    "front_dense": ("frontend", "shard", dict(min_length=14,
                                              sparse_seeds="off"), ()),
}
FQS_K = 12


def _qry_padded(name):
    return seed_mode.pad_query(INPUTS[name][1])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every job run on gloo worlds of 2 and 4 ranks: {w: [results of rank
    r]}."""
    d = tmp_path_factory.mktemp("mesh")
    arrays = {}
    for name, (ref, qry) in INPUTS.items():
        arrays[f"{name}.ref"], arrays[f"{name}.qry"] = ref, qry
    arrays["front.qry"] = _qry_padded("shard")
    np.savez(d / "inputs.npz", **arrays)
    jobs = [{"name": n, "kind": kind, "ref": f"{i}.ref",
             "qry": "front.qry" if kind == "frontend" else f"{i}.qry",
             "cfg": cfg, "modes": list(modes)}
            for n, (kind, i, cfg, modes) in JOBS.items()]
    m = int(_qry_padded("rep").shape[0])
    jobs.append({"name": "fqs", "kind": "full_query_step", "ref": "rep.ref",
                 "qry": "rep.qry", "cfg": {}, "k": FQS_K,
                 "m_off": (m + m + 2) // 2})
    out = {}
    for w in (2, 4):
        spec = d / f"job{w}.json"
        spec.write_text(json.dumps({"inputs": str(d / "inputs.npz"),
                                    "jobs": jobs, "out": str(d / f"w{w}")}))
        rcs = run_ranks([[sys.executable, "-c", RUNNER, str(spec)]] * w)
        for r, (rc, err) in enumerate(rcs):
            assert rc == 0, (w, r, err[-3000:])
        out[w] = [dict(np.load(d / f"w{w}.{r}.npz")) for r in range(w)]
    return out


def _jax_mesh_matches(kind, inp, fields, w):
    ref, qry = INPUTS[inp]
    jidx = jax_build(ref)
    jm = jmesh.make_mesh(w)
    if kind == "sharded":
        return jsh.find_seed_matches_sharded(jidx, qry, JaxConfig(**fields),
                                             jm)
    return jseed.find_seed_matches(jmesh.put_replicated(jidx, jm), qry,
                                   JaxConfig(**fields), mesh=jm)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("job", sorted(n for n, j in JOBS.items()
                                       if j[0] != "frontend"))
def test_mesh_matches_equal_jax_single_and_virtual(worlds, job, w):
    """Every rank lists the same tuples; they equal the JAX mesh's on
    make_mesh(w), the port's single-device engine's and (sharded) the
    port's virtual path with w slabs, in each mode."""
    kind, inp, fields, modes = JOBS[job]
    ref, qry = INPUTS[inp]
    res = worlds[w]
    tidx = _port_index(jax_build(ref))
    jm = _jax_mesh_matches(kind, inp, fields, w)
    single = seed_mode.find_seed_matches(tidx, qry, Config(**fields))
    virtual = (sharded.find_seed_matches_sharded(tidx, qry, Config(**fields),
                                                 n_slabs=w)
               if kind == "sharded" else single)
    for mode in modes:
        cfg = Config(**fields, mode=MatchMode(mode))
        want = _tuples(seed_mode.apply_mode_filter(single, cfg))
        assert want == _tuples(jseed.apply_mode_filter(
            jm, JaxConfig(**fields, mode=JaxMode(mode)))), mode
        assert want == _tuples(seed_mode.apply_mode_filter(virtual, cfg))
        for r in range(w):
            assert _rows(res[r][f"{job}/{mode}"]) == want, (mode, r)
        assert len(want) > 0
    if job == "cross":
        assert want == [(0, 0, 1200)]
    stats = [tuple(res[r][f"{job}/stats"]) for r in range(w)]
    assert len(set(stats)) == 1
    rounds, pairs, k, stride = stats[0]
    assert (k, stride) == (single.stats["k"], single.stats["stride"])
    assert pairs == (virtual if kind == "sharded" else single).stats["pairs"]
    if job in ("rep_sparse", "rep_dense"):
        # several groups of w rounds, the last one short
        assert rounds > 2 * w and rounds % w != 0
    if job == "shard_rounds":
        assert rounds > 1


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("job", ["front_sparse", "front_dense"])
def test_mesh_frontend_equals_virtual_and_jax(worlds, job, w):
    """Rank i's slab widths == the virtual frontend's slab i (lo equal
    where the width is > 0); the worst-slab cum and (total, max) == the
    virtual path's and the JAX mesh frontend's (sharded_frontend over
    shard_tables on make_mesh(w)); the per-slab totals == the virtual
    ones."""
    _, inp, fields, _ = JOBS[job]
    ref, _ = INPUTS[inp]
    qp = _qry_padded(inp)
    res = worlds[w]
    jidx = jax_build(ref)
    tidx = _port_index(jidx)
    k, stride, _ = seed_mode.choose_seed_plan(tidx.n, len(qp),
                                              Config(**fields))
    assert (stride > 1) == (job == "front_sparse")
    t = sharded.virtual_slab_tables(tidx, k, w)
    lo, wd, cum, summary = sharded.virtual_frontend(
        t[0], t[2], t[3], t[4], torch.from_numpy(qp), w, t[7], k, t[5],
        t[6], stride)
    jm = jmesh.make_mesh(w)
    refk_sh, _, starts_sh, jshift, jprobes = jsh.shard_tables(jidx, k, jm)
    _, _, jcum, jsummary = jsh.sharded_frontend(
        jm, refk_sh, starts_sh, jnp.asarray(qp), k, jshift, jprobes, stride)
    for r in range(w):
        got = res[r]
        assert tuple(got[f"{job}/plan"]) == (k, stride, t[5], t[6], t[7])
        assert np.array_equal(got[f"{job}/w"], wd[r].numpy())
        sel = got[f"{job}/w"] > 0
        assert np.array_equal(got[f"{job}/lo"][sel], lo[r].numpy()[sel])
        assert np.array_equal(got[f"{job}/cum"], cum.numpy())
        assert np.array_equal(got[f"{job}/summary"], summary.numpy())
        assert np.array_equal(got[f"{job}/cum"], np.asarray(jcum))
        assert np.array_equal(got[f"{job}/summary"][:2],
                              np.asarray(jsummary))
    assert int(summary[0]) > 0 and int((wd > 0).sum(1).min()) > 0


@pytest.mark.parametrize("w", [2, 4])
def test_full_query_step_gathers_every_block(worlds, w):
    """full_query_step on w blocks of query keys: the gathered runs, one
    batch per rank's block, merge to the runs of one device's whole
    query; the summed pair count is the whole query's."""
    ref, qry = INPUTS["rep"]
    tidx = _port_index(jax_build(ref))
    qt = torch.from_numpy(_qry_padded("rep"))
    m = int(qt.shape[0])
    m_off = (m + m + 2) // 2
    qk, qv = seed_mode.packed_key_words(qt, FQS_K)
    refk, sa_aug = seed_mode.seed_table(tidx, FQS_K)
    lo, width = seed_mode._join_intervals(refk, qk, qv)
    d_s, q_s = seed_mode._expand_pairs_core(sa_aug, lo, width, 0, m_off)
    want = seed_mode.runs_from_sorted_pairs(d_s.numpy(), q_s.numpy(), m_off)
    for r in range(w):
        got = worlds[w][r]
        runs = got["fqs/runs"].astype(np.int64)
        parts = np.split(runs, np.cumsum(got["fqs/counts"])[:-1])
        merged = seed_mode.merge_runs([seed_mode.RunBatch(
            p[:, 0] - m_off, p[:, 1], p[:, 2]) for p in parts])
        for f in ("diag", "qstart", "qend"):
            assert np.array_equal(getattr(merged, f), getattr(want, f)), f
        assert int(got["fqs/total"]) == int(d_s.shape[0])
    assert want.diag.size > 0


@pytest.fixture
def one_rank():
    """A gloo group of one rank in this process, destroyed afterwards."""
    with _reserved_port() as port:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=1, rank=0)
    try:
        yield mesh.make_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fields", [
    dict(min_length=14), dict(min_length=14, sparse_seeds="off"),
    dict(min_length=14, match_backend="boundary"),
    dict(min_length=14, pair_capacity=100)])
def test_one_rank_mesh_branches_equal_single_device(one_rank, fields):
    """At world size 1 over a real group (the CPU image of the chip check's
    one-rank NCCL mesh), the replicated engine given the mesh and the
    forced one-slab-per-rank branch list the single-device engine's
    tuples, and their stages include the collectives; with no mesh the
    replicated engine gathers nothing."""
    assert one_rank.size == 1 and one_rank.group is not None
    ref, qry = INPUTS["shard"]
    tidx = _port_index(jax_build(ref))
    cfg = Config(**fields)
    single = seed_mode.find_seed_matches(tidx, qry, cfg)
    want = _tuples(single)
    rep = seed_mode.find_seed_matches(tidx, qry, cfg, one_rank)
    shd = sharded.find_seed_matches_sharded_mesh(tidx, qry, cfg, one_rank)
    assert _tuples(rep) == want and len(want) > 0
    assert _tuples(shd) == want
    assert "gather" in rep.stats["stage_s"]
    assert "gather" in shd.stats["stage_s"]
    assert rep.stats["ranks"] == 1 and shd.stats["shards"] == 1
    assert "gather" not in single.stats["stage_s"]
    assert "ranks" not in single.stats


def test_collectives_on_one_rank(one_rank):
    t = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    got, counts = mesh.all_gather_ragged(one_rank, t)
    assert torch.equal(got, t) and counts == [3]
    empty, counts = mesh.all_gather_ragged(one_rank, t[:0])
    assert empty.shape == (0, 2) and counts == [0]
    assert torch.equal(mesh.all_reduce_max(one_rank, t), t)
    assert torch.equal(mesh.all_reduce_sum(one_rank, t), t)
    assert mesh.is_output_process() and mesh.world_size() == 1


def test_initialize_multihost_reads_the_launcher_variables(monkeypatch):
    """No coordinator: nothing to join, a world of one rank without a
    group. A coordinator without a count or an id is refused, naming what
    is missing (the JAX package's cluster auto-detection is not
    ported)."""
    for v in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "JAX_NUM_PROCESSES", "NUM_PROCESSES", "JAX_PROCESS_ID",
              "PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    assert mesh.initialize_multihost("cpu") is False
    m = mesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.group) == (1, 0, None)
    with pytest.raises(ValueError, match="requested 2"):
        mesh.make_mesh(2, "cpu")
    t = torch.ones(3)
    assert mesh.all_gather_ragged(m, t)[0] is t
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="PROCESS_ID"):
        mesh.initialize_multihost("cpu")
    assert not dist.is_initialized()


def test_sharded_mesh_refuses_other_slab_counts():
    """On a mesh of w > 1 ranks the slab count must be w, as in the JAX
    package (checked before any collective)."""
    fake = mesh.Mesh(2, 0, torch.device("cpu"), group=object())
    ref, qry = INPUTS["rep"]
    tidx = _port_index(jax_build(ref))
    with pytest.raises(ValueError, match="must equal the device count"):
        sharded.find_seed_matches_sharded(tidx, qry, Config(), fake,
                                          n_slabs=3)
