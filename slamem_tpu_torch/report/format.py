"""MUMmer-style match listing formatter (port of the Python renderer of
``slamem_tpu/report/format.py``; the JAX package's native C renderer gives
the same bytes and is not ported yet, ROADMAP A5).

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


def _format_python(out: EngineOutput, buf: io.StringIO) -> None:
    multi_ref = len(out.ref_names) > 1
    name_w = max((len(n) for n in out.ref_names), default=0)
    for qm in out.per_query:
        header = f"> {qm.query_name}"
        if qm.reverse:
            header += " Reverse"
        buf.write(header + "\n")
        for k in range(qm.length.size):
            rp = int(qm.ref_pos[k]) + 1
            qp = int(qm.q_pos[k]) + 1
            ln = int(qm.length[k])
            if multi_ref:
                rn = out.ref_names[int(qm.ref_seq[k])]
                buf.write(f"  {rn:<{name_w}}  {rp:>8}  {qp:>8}  {ln:>8}\n")
            else:
                buf.write(f"{rp:>8}  {qp:>8}  {ln:>8}\n")


def format_matches(out: EngineOutput) -> str:
    """Render the full listing for all query sequences/strands."""
    buf = io.StringIO()
    _format_python(out, buf)
    return buf.getvalue()
