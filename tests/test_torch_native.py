"""Port vs JAX package: the native FASTA parser and listing renderer.

The port's C parser (``slamem_tpu_torch/_native/fastaio.c``) is held to the
port's numpy parser and to the JAX package's ``parse_fasta_bytes``; the
port's C renderer (``matchfmt.c``) to the port's Python renderer and to the
JAX package's ``format_matches``. Inputs are fixed cases and numpy-seeded
fuzz. Tolerance: exact — names, extents, codes and listing bytes must be
equal. Also: the build step raises on a failed build and stays correct
when several processes build the same library at once.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from slamem_tpu.engine.run import EngineOutput as JaxOutput
from slamem_tpu.engine.run import QueryMatches as JaxQueryMatches
from slamem_tpu.io.fasta import parse_fasta_bytes as jax_parse
from slamem_tpu.report.format import format_matches as jax_format

from slamem_tpu_torch import _native
from slamem_tpu_torch._native import fastaio, matchfmt
from slamem_tpu_torch.engine.run import EngineOutput, QueryMatches
from slamem_tpu_torch.io.fasta import parse_fasta_bytes, read_fasta
from slamem_tpu_torch.report.format import (format_matches,
                                             format_matches_python)

CASES = [
    b">seq1 desc here\nACGT\nNNAC\n>seq2\ngggt\n",
    b">a\r\nAC GT\r\n\r\n>b\nTT\tAA\n",
    b">x\nARYSWKMBDHVNacgt\n",
    b">only-header\n",
    b">n1\nACGT",                      # no trailing newline
    b"> spaced-name  rest\nAC\n",
    b">a\nACGT\n>b\n>c\nTT\n",          # empty middle record
    b">chr1 desc\r\nACGTRYacgtn\r\nNNac\r\n>\nGG TT\tA\n>c3\n\n",
    b">x>y\nAC>GT\n>\t\r\nA\n",         # '>' off a line start is payload
]


def _assert_same_set(a, b):
    assert a.names == b.names
    for f in ("starts", "lengths", "codes"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("buf", CASES)
def test_native_parser_equals_numpy_and_jax(buf):
    got = fastaio.parse(buf)
    _assert_same_set(parse_fasta_bytes(buf), got)
    _assert_same_set(jax_parse(buf), got)


@pytest.mark.parametrize("buf", [b"", b"ACGT\n", b"no header at all",
                                 b"ACGT\n>x\nA\n"])
def test_native_parser_rejects_bad_input(buf, tmp_path):
    with pytest.raises(ValueError):
        parse_fasta_bytes(buf)
    with pytest.raises(ValueError):
        fastaio.parse(buf)
    path = tmp_path / "bad.fa"
    path.write_bytes(buf)
    with pytest.raises(ValueError):
        read_fasta(path)


def test_native_parser_fuzz():
    rng = np.random.default_rng(90)
    alphabet = b"ACGTNacgtn \t\r\n>xyz|123"
    for _ in range(80):
        n = int(rng.integers(1, 400))
        body = bytes(alphabet[i] for i in
                     rng.integers(0, len(alphabet), size=n))
        buf = b">f\n" + body  # a leading header
        got = fastaio.parse(buf)
        _assert_same_set(parse_fasta_bytes(buf), got)
        _assert_same_set(jax_parse(buf), got)


def test_read_fasta_runs_the_native_parser(tmp_path, monkeypatch):
    path = tmp_path / "in.fa"
    path.write_bytes(CASES[0])
    calls = []
    real = fastaio.parse
    monkeypatch.setattr(fastaio, "parse",
                        lambda buf, src: calls.append(src) or real(buf, src))
    _assert_same_set(parse_fasta_bytes(CASES[0]), read_fasta(path))
    assert calls == [str(path)]


def _outputs(rng, ref_names):
    """The same random listing as a port and a JAX EngineOutput."""
    n_ref = len(ref_names)
    rows = []
    for qi in range(int(rng.integers(1, 4))):
        n = int(rng.integers(0, 50))
        hi = int(rng.integers(10, 10 ** int(rng.integers(2, 12))) + 2)
        rows.append(dict(
            query_name=f"q{qi}", reverse=bool(rng.integers(0, 2)),
            ref_seq=rng.integers(0, n_ref, n).astype(np.int64),
            ref_pos=rng.integers(0, hi, n).astype(np.int64),
            q_pos=rng.integers(0, hi, n).astype(np.int64),
            length=rng.integers(1, hi, n).astype(np.int64)))
    return (EngineOutput(ref_names=list(ref_names),
                         per_query=[QueryMatches(**r) for r in rows],
                         stats={}),
            JaxOutput(ref_names=list(ref_names),
                      per_query=[JaxQueryMatches(**r) for r in rows],
                      stats={}))


def test_native_renderer_equals_python_and_jax():
    """Fuzzed single- and multi-reference listings (numbers past 8 digits,
    empty queries, names of unequal widths): native bytes == Python bytes
    == the JAX package's bytes."""
    rng = np.random.default_rng(500)
    for trial in range(24):
        n_ref = int(rng.integers(1, 4))
        names = [f"ref{'X' * int(rng.integers(0, 9))}{i}"
                 for i in range(n_ref)]
        out, jout = _outputs(rng, names)
        native = format_matches(out)
        assert native == format_matches_python(out), trial
        assert native == jax_format(jout, force="python"), trial


def test_non_ascii_reference_names_render_natively(capsys):
    """Python pads the name column by characters; the native renderer gets
    the names padded so, and gives the same bytes for non-ASCII names as
    the Python renderer and the JAX package, with no note on stderr."""
    rng = np.random.default_rng(501)
    out, jout = _outputs(rng, ["chrÅ", "chr_b_long", "c", "réf_é"])
    got = format_matches(out)
    assert capsys.readouterr().err == ""
    assert got == format_matches_python(out)
    assert got == jax_format(jout, force="python")
    assert "  chrÅ        " in got          # 4 chars padded to 10, then gap


def test_render_rejects_bad_reference_ids():
    with pytest.raises(ValueError):
        matchfmt.render_multi(np.array([0, 2]), np.ones(2), np.ones(2),
                              np.ones(2), ["a", "b"])


def test_failed_build_raises(tmp_path):
    src = tmp_path / "broken.c"
    src.write_text("int f(void) { return not_declared; }\n")
    with pytest.raises(RuntimeError, match="not_declared"):
        _native.build_shared(_native.find_tool("gcc"), _native.GCC_FLAGS,
                             src, tmp_path / "build", "broken")
    assert list((tmp_path / "build").iterdir()) == []   # no partial file
    with pytest.raises(RuntimeError, match="not found"):
        _native.find_tool("no-such-compiler-here")


def test_concurrent_builds_give_one_library(tmp_path):
    """Eight processes build the same source into one directory at once
    (as test workers do on a first use): every one loads a whole library,
    one file remains, and no temporary file is left behind."""
    src = tmp_path / "add.c"
    src.write_text("long add(long a, long b) { return a + b; }\n")
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from slamem_tpu_torch import _native\n"
        "p, _ = _native.build_shared(_native.find_tool('gcc'), "
        "_native.GCC_FLAGS, Path(sys.argv[1]), Path(sys.argv[2]), 'add')\n"
        "assert ctypes.CDLL(str(p)).add(40, 2) == 42\n"
    )
    repo = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src),
                               str(tmp_path / "build")], cwd=repo,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(8)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert [f.suffix for f in (tmp_path / "build").iterdir()] == [".so"]
