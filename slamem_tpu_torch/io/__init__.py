from slamem_tpu_torch.io.fasta import (  # noqa: F401
    FastaSet,
    Sequence,
    read_fasta,
    parse_fasta_bytes,
    write_fasta,
    CODE_A, CODE_C, CODE_G, CODE_T, CODE_N, CODE_SEP,
    codes_to_str,
    str_to_codes,
    revcomp_codes,
)
