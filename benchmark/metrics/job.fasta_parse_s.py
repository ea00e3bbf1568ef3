"""Mean seconds a job of the CLI's ``fasta_parse`` spans (``read_fasta``:
the C parser over each input file's bytes), summed per job."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "fasta_parse")
