"""Mean seconds a job of the CLI's ``fasta_read`` spans (``io/fasta.py::
read_fasta``: open, read and gunzip each input file), summed per job."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "fasta_read")
