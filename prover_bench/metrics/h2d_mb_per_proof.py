"""Bytes copied from the host to the card a proof, in MB (1e6 bytes):
the program's counter ``h2d_bytes``, a median over the window's
proofs."""

from prover_bench.spans import median_counter


def read(ctx):
    v = median_counter(ctx, "h2d_bytes")
    return None if v is None else v / 1e6
