"""The port end to end: FASTA -> index -> seed or scan engine -> listing.

The port's CLI (``-device cpu``) and the JAX package's CLI read the same
FASTA files (made with numpy from seeds), through the default (seed) engine
or both with ``-engine scan``. Tolerance: exact — the listing bytes must be
identical; one case of each engine is also held to the brute-force
oracle's match set. The first step, FASTA reading, must give the JAX
reader's names, extents and codes exactly.
"""

import gzip
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from slamem_tpu.cli.main import main as jax_main
from slamem_tpu.io import Sequence, write_fasta
from slamem_tpu.io import read_fasta as jax_read_fasta
from slamem_tpu.io.fasta import revcomp_codes as jax_revcomp
from slamem_tpu.oracle import oracle_matches
from slamem_tpu.utils.synth import mutate, random_genome, with_n_runs

from slamem_tpu_torch.cli.main import main
from slamem_tpu_torch.config import Config
from slamem_tpu_torch.engine.run import run_engine
from slamem_tpu_torch.index.build import build_index
from slamem_tpu_torch.io.fasta import read_fasta, revcomp_codes

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, seqs):
    write_fasta(path, [Sequence(name, s) for name, s in seqs])
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    base = random_genome(4000, seed=201)
    base[2500:2900] = base[600:1000]            # a repeat (MUM/MAM differ)
    single_ref = _write(d / "ref1.fa", [("refseq", base)])
    single_qry = _write(d / "qry1.fa",
                        [("qryseq", mutate(base, 0.02, 0.002, seed=202))])
    nref = with_n_runs(base, 4, 30, seed=203)
    nqry = with_n_runs(mutate(base, 0.02, 0.002, seed=204), 3, 20, seed=205)
    n_ref = _write(d / "refn.fa", [("refN", nref)])
    n_qry = _write(d / "qryn.fa", [("qryN", nqry)])
    multi_ref = _write(d / "refm.fa", [("chrA", nref[:1700]),
                                       ("chrB_long_name", nref[1700:3300]),
                                       ("c", nref[3300:])])
    multi_qry = _write(d / "qrym.fa", [("r1", nqry[200:1900]),
                                       ("r2", nqry[2200:3800])])
    return {"single": (single_ref, single_qry), "n_runs": (n_ref, n_qry),
            "multi": (multi_ref, multi_qry), "dir": d}


FASTA_BYTES = {
    "multi_crlf_lower_iupac": b">chr1 desc\r\nACGTRYacgtn\r\nNNac\r\n>\n"
                              b"GG TT\tA\n>c3\n\n",
    "one_line_no_newline": b">x\nACGT",
    "gzip": None,  # the multi record above, gzipped
}


@pytest.mark.parametrize("case", sorted(FASTA_BYTES))
def test_fasta_read_equals_jax(case, tmp_path):
    buf = FASTA_BYTES[case]
    if buf is None:
        buf = gzip.compress(FASTA_BYTES["multi_crlf_lower_iupac"])
    path = tmp_path / "in.fa"
    path.write_bytes(buf)
    want, got = jax_read_fasta(path), read_fasta(path)
    assert got.names == want.names
    for f in ("starts", "lengths", "codes"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(jax_revcomp(want.codes), revcomp_codes(got.codes))
    for a, b in zip(want.with_separators(), got.with_separators()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("buf", [b"", b"ACGT\n>x\nA\n"])
def test_fasta_rejects_what_jax_rejects(buf, tmp_path):
    path = tmp_path / "bad.fa"
    path.write_bytes(buf)
    with pytest.raises(ValueError):
        jax_read_fasta(path)
    with pytest.raises(ValueError):
        read_fasta(path)


SCAN = ["-engine", "scan"]
CASES = {
    "single_l15": ("single", [*SCAN, "-l", "15"]),
    "n_runs_l12": ("n_runs", [*SCAN, "-l", "12"]),
    "multi_b": ("multi", [*SCAN, "-b", "-l", "14"]),
    "multi_b_mum": ("multi", [*SCAN, "-b", "-mum", "-l", "14"]),
    "multi_b_mam": ("multi", [*SCAN, "-b", "-mam", "-l", "14"]),
    "single_mum": ("single", [*SCAN, "-mum", "-l", "16"]),
    # the default engine (seed), no -engine flag on either CLI
    "default_single_l20": ("single", ["-l", "20"]),
    "default_n_runs_l12": ("n_runs", ["-l", "12"]),
    "default_multi_b": ("multi", ["-b", "-l", "14"]),
    "default_multi_b_mum": ("multi", ["-b", "-mum", "-l", "14"]),
    "default_multi_b_mam": ("multi", ["-b", "-mam", "-l", "14"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_listing_bytes_equal_jax(inputs, case, tmp_path):
    which, flags = CASES[case]
    ref, qry = inputs[which]
    jout, tout = str(tmp_path / "jax.txt"), str(tmp_path / "torch.txt")
    assert jax_main([*flags, "-o", jout, ref, qry]) == 0
    assert main([*flags, "-device", "cpu", "-o", tout, ref, qry]) == 0
    want = open(jout, "rb").read()
    assert open(tout, "rb").read() == want
    assert want.count(b"\n") > want.count(b">") + 2  # matches were listed


def _oracle_check(inputs, tmp_path, flags):
    ref, qry = inputs["n_runs"]
    out = str(tmp_path / "o.txt")
    assert main([*flags, "-device", "cpu", "-l", "13", "-o", out,
                 ref, qry]) == 0
    got = sorted(tuple(int(x) - (i < 2) for i, x in enumerate(line.split()))
                 for line in open(out) if not line.startswith(">"))
    want = sorted(oracle_matches(read_fasta(ref).codes,
                                 read_fasta(qry).codes, 13, "mem"))
    assert got == want and len(want) > 0


def test_cli_matches_oracle(inputs, tmp_path):
    _oracle_check(inputs, tmp_path, SCAN)


def test_cli_default_engine_matches_oracle(inputs, tmp_path):
    _oracle_check(inputs, tmp_path, [])


def test_save_load_both_packages(inputs, tmp_path):
    ref, qry = inputs["single"]
    flags = ["-engine", "scan", "-l", "15"]
    base_out = str(tmp_path / "base.txt")
    assert main([*flags, "-device", "cpu", "-o", base_out, ref, qry]) == 0
    want = open(base_out, "rb").read()
    # port save -> port load; JAX save -> port load
    tnpz, jnpz = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert main(["-save", tnpz, "-device", "cpu", ref]) == 0
    assert jax_main(["-save", jnpz, ref]) == 0
    for npz in (tnpz, jnpz):
        out = str(tmp_path / "out.txt")
        assert main([*flags, "-device", "cpu", "-load", npz, "-o", out,
                     ref, qry]) == 0
        assert open(out, "rb").read() == want
    # an index of another reference is refused
    other, _ = inputs["multi"]
    assert main([*flags, "-device", "cpu", "-load", tnpz, "-o",
                 str(tmp_path / "x.txt"), other, qry]) == 2


@pytest.mark.parametrize("flags", [
    ["-shard"],                          # default engine: seed
    ["-plot", "x.bmp"],
    ["-engine", "scan", "-shard"],
    ["-engine", "scan", "-slabs", "2"],
    ["-engine", "scan", "-plot", "x.bmp"],
    ["-shard", "-slabs", "3"],
    ["-shard", "-slabs", "3", "-b", "-mum"],
    ["-slabs", "2"],                     # without -shard: replicated
])
def test_unported_options_exit_2(inputs, flags, tmp_path):
    """The options the port once refused with exit status 2 (-shard,
    -slabs, -plot) now give the JAX CLI's exit status, listing bytes and
    dot-plot bytes; -engine scan -shard exits 2 in both."""
    ref, qry = inputs["single"]
    got = {}
    for pkg, cli, extra in (("jax", jax_main, []),
                            ("torch", main, ["-device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        argv = [str(d / f) if f == "x.bmp" else f for f in flags]
        rc = cli([*argv, *extra, "-o", str(d / "out.txt"), ref, qry])
        got[pkg] = (rc, *(p.read_bytes() if p.exists() else None
                          for p in (d / "out.txt", d / "x.bmp")))
    assert got["torch"] == got["jax"]
    rc, listing, bmp = got["jax"]
    if flags[:3] == ["-engine", "scan", "-shard"]:
        assert rc == 2 and listing is None
    else:
        assert rc == 0 and listing.count(b"\n") > 2
        assert (bmp is not None) == ("-plot" in flags)


def test_bad_device_flag_exits_2(inputs):
    ref, qry = inputs["single"]
    assert main(["-engine", "scan", "-device", "tpu", ref, qry]) == 2


def test_cuda_without_a_card_raises(inputs, monkeypatch):
    """Asking for CUDA where there is none raises; nothing drops to the
    CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, qry = inputs["single"]
    with pytest.raises(RuntimeError, match="cuda"):
        build_index(random_genome(100, seed=1), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        run_engine(read_fasta(ref), read_fasta(qry),
                   Config(engine="scan"), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-engine", "scan", "-o", "-", ref, qry])  # default -device cuda


def test_port_imports_no_jax(inputs, tmp_path):
    """The port's CLI, run end to end through both engines, leaves jax and
    slamem_tpu out of sys.modules."""
    ref, qry = inputs["single"]
    code = (
        "import sys\n"
        "from slamem_tpu_torch.cli.main import main\n"
        f"assert main(['-engine', 'scan', '-device', 'cpu', '-l', '15', "
        f"'-o', {str(tmp_path / 'o.txt')!r}, {ref!r}, {qry!r}]) == 0\n"
        f"assert main(['-device', 'cpu', '-l', '15', '-o', "
        f"{str(tmp_path / 's.txt')!r}, {ref!r}, {qry!r}]) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'slamem_tpu' or "
        "m.startswith('slamem_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert open(tmp_path / "o.txt").read() == open(tmp_path / "s.txt").read()
    assert open(tmp_path / "o.txt").read().count("\n") > 1


def test_port_sources_import_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax, jaxlib or the
    JAX package."""
    bad = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|slamem_tpu)\b"
                     r"(?!_torch)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "slamem_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    offenders = [p for p in paths if bad.search(open(p).read())]
    assert not offenders, offenders
