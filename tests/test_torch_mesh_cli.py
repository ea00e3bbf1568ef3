"""Port vs JAX package: the CLI launched as two processes (the JAX package's
launcher variables, ``-device cpu``, gloo), as tests/test_dist.py launches
the JAX CLI.

Rank 0's listing (and dot-plot) bytes must equal both the single-process
port listing and the JAX CLI's listing; rank 1 computes the same and
writes nothing. The options the JAX CLI refuses on a mesh exit 2 on every
rank. Tolerance: exact bytes.
"""

import os
import subprocess
import sys

import pytest
import torch

from slamem_tpu.cli.main import main as jax_main
from slamem_tpu.io import Sequence, write_fasta
from slamem_tpu.utils.synth import mutate, random_genome, with_n_runs

from slamem_tpu_torch.cli.main import main

from test_torch_mesh import REPO, rank_env, run_ranks

# The port's CPU path is many tiny ops: one intra-op thread per test worker
# keeps parallel workers from oversubscribing the cores with idle spinners.
torch.set_num_threads(1)

CLI = [sys.executable, "-m", "slamem_tpu_torch.cli.main", "-device", "cpu"]


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """tests/test_dist.py's pair, and a multi-FASTA pair with a repeat (so
    MUM / MAM drop matches) and N runs for ``-b``."""
    d = tmp_path_factory.mktemp("meshcli")
    ref = random_genome(3000, seed=901)
    paths = {"single": (d / "r.fa", d / "q.fa"),
             "multi": (d / "rm.fa", d / "qm.fa")}
    write_fasta(paths["single"][0], [Sequence("R", ref)])
    write_fasta(paths["single"][1],
                [Sequence("Q", mutate(ref, 0.02, 0.002, seed=902))])
    base = random_genome(4000, seed=201)
    base[2500:2900] = base[600:1000]
    nref = with_n_runs(base, 4, 30, seed=203)
    nqry = with_n_runs(mutate(base, 0.02, 0.002, seed=204), 3, 20, seed=205)
    write_fasta(paths["multi"][0], [Sequence("chrA", nref[:1700]),
                                    Sequence("chrB", nref[1700:])])
    write_fasta(paths["multi"][1], [Sequence("r1", nqry[200:1900]),
                                    Sequence("r2", nqry[2200:3800])])
    return {k: (str(a), str(b)) for k, (a, b) in paths.items()}


VARIANTS = {
    "plain": ("single", ["-l", "14"]),
    "shard_plot": ("single", ["-l", "14", "-shard", "-plot", "{d}/p{r}.bmp"]),
    "b_mum": ("multi", ["-l", "14", "-b", "-mum"]),
    "shard_b_mam": ("multi", ["-l", "14", "-shard", "-b", "-mam"]),
}


def _argv(flags, d, r):
    return [f.format(d=d, r=r) for f in flags]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_process_cli_rank0_bytes_equal_jax(fasta, variant, tmp_path):
    which, flags = VARIANTS[variant]
    ref, qry = fasta[which]
    d = str(tmp_path)
    rcs = run_ranks([[*CLI, *_argv(flags, d, r), "-o",
                      str(tmp_path / f"out{r}.txt"), ref, qry]
                     for r in range(2)])
    for r, (rc, err) in enumerate(rcs):
        assert rc == 0, (r, err[-3000:])
    assert not (tmp_path / "out1.txt").exists(), "rank 1 must write nothing"
    listing = (tmp_path / "out0.txt").read_bytes()
    one = tmp_path / "one"
    one.mkdir()
    assert main([*_argv(flags, str(one), 0), "-device", "cpu", "-o",
                 str(one / "out.txt"), ref, qry]) == 0
    assert listing == (one / "out.txt").read_bytes()
    jax_flags = [f for f in _argv(flags, str(one), "j")]
    assert jax_main([*jax_flags, "-o", str(one / "jax.txt"), ref, qry]) == 0
    assert listing == (one / "jax.txt").read_bytes()
    assert listing.count(b"\n") > listing.count(b">") + 2
    if "-plot" in flags:
        assert not (tmp_path / "p1.bmp").exists()
        bmp = (tmp_path / "p0.bmp").read_bytes()
        assert bmp == (one / "p0.bmp").read_bytes() == (
            one / "pj.bmp").read_bytes()


@pytest.mark.parametrize("flags", [["-shard", "-slabs", "3"],
                                   ["-engine", "scan"]])
def test_two_process_cli_refusals_exit_2(fasta, flags, tmp_path):
    """-shard -slabs 3 on 2 processes (slabs ride ranks) and -engine scan
    on a mesh exit 2 on every rank, as the JAX CLI does; nothing is
    written."""
    ref, qry = fasta["single"]
    rcs = run_ranks([[*CLI, *flags, "-o", str(tmp_path / f"o{r}.txt"), ref,
                      qry] for r in range(2)])
    for r, (rc, err) in enumerate(rcs):
        assert rc == 2 and "error:" in err, (r, rc, err[-2000:])
    assert not list(tmp_path.glob("o*.txt"))


def test_two_process_save_on_rank0_only(fasta, tmp_path):
    """-save writes the index on rank 0 only; it loads in one process and
    gives the listing of a fresh build."""
    ref, qry = fasta["single"]
    rcs = run_ranks([[*CLI, "-save", str(tmp_path / f"i{r}.npz"), ref]
                     for r in range(2)])
    assert [rc for rc, _ in rcs] == [0, 0], rcs
    assert (tmp_path / "i0.npz").exists()
    assert not (tmp_path / "i1.npz").exists()
    outs = []
    for extra in ([], ["-load", str(tmp_path / "i0.npz")]):
        o = str(tmp_path / f"o{len(outs)}.txt")
        assert main([*extra, "-device", "cpu", "-o", o, ref, qry]) == 0
        outs.append(open(o, "rb").read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("bad", ["missing", "corrupt"])
def test_load_failure_exit_status_equals_jax(fasta, bad, tmp_path):
    """-load of a missing or corrupt file: the exception escapes both CLIs
    (the JAX CLI does not catch it), so the process exits 1 with the
    traceback, as the JAX CLI's does."""
    ref, qry = fasta["single"]
    npz = tmp_path / "i.npz"
    if bad == "corrupt":
        npz.write_bytes(b"not an index")
    argv = ["-load", str(npz), "-o", str(tmp_path / "o.txt"), ref, qry]
    with pytest.raises(Exception) as jerr:
        jax_main(argv)
    with pytest.raises(Exception) as terr:
        main([*argv, "-device", "cpu"])
    assert type(terr.value) is type(jerr.value)
    env = {k: v for k, v in rank_env(0, 1, 0).items()
           if not k.startswith("JAX_")}
    proc = subprocess.run([*CLI, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "Traceback" in proc.stderr
    assert not os.path.exists(tmp_path / "o.txt")
