"""Port vs JAX package: the native FASTA parser and listing renderer.

The port's C parser (``slamem_tpu_torch/_native/fastaio.c``) is held to the
port's numpy parser and to the JAX package's ``parse_fasta_bytes``; the
port's C renderer (``matchfmt.c``) to the port's Python renderer and to the
JAX package's ``format_matches``. Inputs are fixed cases and numpy-seeded
fuzz. Tolerance: exact — names, extents, codes and listing bytes must be
equal. Also: the build step raises on a failed build and stays correct
when several processes build the same library at once.
"""

import re
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
from slamem_tpu_torch.utils.log import PhaseLog


def _body(n: int, seed: int, letters: bytes = b"ACGTN") -> bytes:
    rng = np.random.default_rng(seed)
    return bytes(np.frombuffer(letters, np.uint8)[
        rng.integers(0, len(letters), n)])


def _lines(body: bytes, width: int, eol: bytes = b"\n") -> bytes:
    return b"".join(body[i:i + width] + eol
                    for i in range(0, len(body), width))


def _byte_sweep(offset: int) -> bytes:
    """Every byte value but '\n' at ``offset`` of a 40-byte line (the
    parser's first two 16-byte steps and a partial third)."""
    line = bytearray(_body(40, 7, b"ACGTacgtN"))
    out = [b">sweep\n"]
    for v in range(256):
        if v != ord("\n"):
            line[offset] = v
            out.append(bytes(line) + b"\n")
    return b"".join(out)


def _space_at_block_edges(ch: bytes) -> bytes:
    """``ch`` at the first, middle and last byte of a 16-byte step, and at
    the first byte of the next one, each in its own 70-wide line."""
    lines = []
    for k, pos in enumerate((0, 8, 15, 16, 69)):
        line = bytearray(_body(70, 20 + k))
        line[pos:pos + 1] = ch
        lines.append(bytes(line) + b"\n")
    return b">ws\n" + b"".join(lines) + _lines(_body(140, 30), 70)


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
    # line widths around the 16-byte step, common file widths, one long
    *(b">w%d\n" % w + _lines(_body(1000, w), w)
      for w in (15, 16, 17, 31, 32, 33, 60, 70, 80)),
    b">long\n" + _body(5000, 5) + b"\n>next\n" + _lines(_body(90, 6), 60),
    *(_byte_sweep(k) for k in range(32)),
    *(_space_at_block_edges(ch) for ch in (b" ", b"\t", b"\r")),
    b">crlf a\r\n" + _lines(_body(1000, 8), 70, b"\r\n") + b">b\r\n"
    + _lines(_body(75, 9), 70, b"\r\n"),
    # soft-masked lowercase runs and N runs
    b">mask\n" + _lines(_body(300, 10) + b"acgtnnacgt" * 30 + b"N" * 200
                        + b"n" * 50 + _body(100, 11, b"acgtn"), 70),
    # a last line without a newline: under a step, one step, one and more
    *(b">end\n" + _lines(_body(140 + k, 12), 70)[:-1] for k in (5, 16, 20)),
    b">gt\n" + _body(40, 13) + b">mid" + _body(40, 14) + b"\n",
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
                                 b"ACGT\n>x\nA\n",
                                 b" \n\t\r\n" + b"ACGT" * 20 + b"\n>x\nA\n",
                                 b"\r\n\n"])
def test_native_parser_rejects_bad_input(buf, tmp_path):
    with pytest.raises(ValueError) as want:
        parse_fasta_bytes(buf)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        fastaio.parse(buf)
    path = tmp_path / "bad.fa"
    path.write_bytes(buf)
    with pytest.raises(ValueError):
        read_fasta(path)


def test_native_parser_fuzz():
    """Short lines with whitespace and '>' everywhere, then bodies of up
    to 20,000 bytes where whitespace, '\n' and '>' are rare (lines of tens
    to thousands of bytes): most lines take the parser's 16-byte steps,
    some fall back mid-line."""
    rng = np.random.default_rng(90)
    alphabet = b"ACGTNacgtn \t\r\n>xyz|123"
    rare = np.frombuffer(b" \t\r\n>x\x00\xff", np.uint8)
    for trial in range(140):
        if trial < 80:
            n = int(rng.integers(1, 400))
            body = bytes(alphabet[i] for i in
                         rng.integers(0, len(alphabet), size=n))
        else:
            n = int(rng.integers(1, 20_000))
            raw = np.frombuffer(b"ACGTNacgt", np.uint8)[
                rng.integers(0, 9, n)]
            hits = rng.random(n) < 10.0 ** rng.uniform(-4, -1.5)
            raw[hits] = rare[rng.integers(0, len(rare), int(hits.sum()))]
            body = raw.tobytes()
        buf = b">f\n" + body  # a leading header
        got = fastaio.parse(buf)
        _assert_same_set(parse_fasta_bytes(buf), got)
        _assert_same_set(jax_parse(buf), got)


@pytest.mark.parametrize("kind", ["lf", "crlf", "space"])
def test_fasta_parse_span_counts_wide_bp(kind, tmp_path):
    """The ``fasta_parse`` record of an active PhaseLog counts the bases
    the 16-byte steps wrote: all of a 70-wide file, with LF or CRLF line
    ends; fewer once a line holds a space (that line falls back), with the
    codes unchanged."""
    buf = b">r\n" + _lines(_body(7000, 15, b"ACGT"), 70,
                           b"\r\n" if kind == "crlf" else b"\n")
    if kind == "space":
        buf = buf[:500] + b" " + buf[500:]
    path = tmp_path / "in.fa"
    path.write_bytes(buf)
    log = PhaseLog(enabled=False)
    with log.activate():
        got = read_fasta(path)
    (rec,) = [r for r in log.records if r["phase"] == "fasta_parse"]
    _assert_same_set(parse_fasta_bytes(buf), got)
    assert rec["bp"] == 7000
    if kind == "space":
        assert 0 < rec["wide_bp"] < rec["bp"]
    else:
        assert rec["wide_bp"] == rec["bp"]


def test_native_codes_are_the_pass_array():
    """The codes are a view of the array the pass wrote, no copy, and the
    set built on them joins and splits as the numpy parser's does."""
    one = b">chr\n" + _lines(_body(1_000_000, 16), 70)
    got = fastaio.parse(one)
    assert got.codes.size == got.total_length == 1_000_000
    assert got.codes.base is not None and got.codes.base.size == len(one) + 16
    multi = b"".join(b">s%d\n" % k + _lines(_body(3000 + 37 * k, 17 + k), 60)
                     for k in range(4))
    got, want = fastaio.parse(multi), parse_fasta_bytes(multi)
    for a, b in zip(got.with_separators(), want.with_separators()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for k in range(4):
        assert got.sequence(k).name == want.sequence(k).name
        assert np.array_equal(got.sequence(k).codes, want.sequence(k).codes)


def test_read_fasta_runs_the_native_parser(tmp_path, monkeypatch):
    path = tmp_path / "in.fa"
    path.write_bytes(CASES[0])
    calls = []
    real = fastaio.parse
    monkeypatch.setattr(fastaio, "parse",
                        lambda buf, src, stats=None: calls.append(src)
                        or real(buf, src, stats))
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
