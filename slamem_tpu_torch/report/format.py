"""MUMmer-style match listing formatter (port of
``slamem_tpu/report/format.py``): the native C renderer
(``slamem_tpu_torch/_native/matchfmt.c``, built by gcc at first use) writes
the match lines; the Python renderer (``format_matches_python``) gives the
same bytes and is the plain version the tests hold it to.

Emitted shape:

    > <query_name>
     <ref_pos>  <query_pos>  <length>                      (single-ref)
      <ref_name>   <ref_pos>  <query_pos>  <length>        (multi-FASTA ref)
    > <query_name> Reverse                                 (with -b)

Positions are 1-based; with -b, reverse-strand query positions are reported
in reverse-complemented-query coordinates. Matches are ordered by query
position, then reference position.
"""

from __future__ import annotations

import io

from slamem_tpu_torch.engine.run import EngineOutput


def _name_width(out: EngineOutput) -> int:
    return max((len(n) for n in out.ref_names), default=0)


def _header(qm) -> str:
    return f"> {qm.query_name}" + (" Reverse" if qm.reverse else "") + "\n"


def format_matches_python(out: EngineOutput) -> str:
    """The listing rendered in Python: the plain version of
    ``format_matches``, which must give the same bytes."""
    buf = io.StringIO()
    multi_ref = len(out.ref_names) > 1
    name_w = _name_width(out)
    for qm in out.per_query:
        buf.write(_header(qm))
        for k in range(qm.length.size):
            rp = int(qm.ref_pos[k]) + 1
            qp = int(qm.q_pos[k]) + 1
            ln = int(qm.length[k])
            if multi_ref:
                rn = out.ref_names[int(qm.ref_seq[k])]
                buf.write(f"  {rn:<{name_w}}  {rp:>8}  {qp:>8}  {ln:>8}\n")
            else:
                buf.write(f"{rp:>8}  {qp:>8}  {ln:>8}\n")
    return buf.getvalue()


def format_matches(out: EngineOutput, force: str | None = None) -> str:
    """Render the full listing for all query sequences/strands; the match
    lines by the native renderer. Reference names are padded here, by
    characters as Python pads them, so C copies them whole and any name
    (non-ASCII too) gives the Python renderer's bytes. ``force`` pins the
    renderer as in the JAX package: None or ``"native"`` the C library
    (which raises where it cannot be built), any other value
    ``format_matches_python``."""
    if force not in (None, "native"):
        return format_matches_python(out)
    from slamem_tpu_torch._native import matchfmt

    buf = io.StringIO()
    multi_ref = len(out.ref_names) > 1
    name_w = _name_width(out)
    padded = [n.ljust(name_w) for n in out.ref_names]
    for qm in out.per_query:
        buf.write(_header(qm))
        if multi_ref:
            lines = matchfmt.render_multi(qm.ref_seq, qm.ref_pos + 1,
                                          qm.q_pos + 1, qm.length, padded)
        else:
            lines = matchfmt.render_single(qm.ref_pos + 1, qm.q_pos + 1,
                                           qm.length)
        buf.write(lines.decode("utf-8"))
    return buf.getvalue()


def write_matches(path: str, out: EngineOutput) -> None:
    """Write the listing (``format_matches``) to ``path``."""
    with open(path, "w") as f:
        f.write(format_matches(out))
