"""Seconds from the harness's start to the window's: imports, the card's
context, inputs, the mix's set-up (FASTA files or the index) and one warm
answer, and in a checkout's first run the kernels' builds."""


def read(run):
    return run.setup_s
