"""The host's conversion of a witness to limbs (``v % R`` and
``field.ints_to_limbs``), ms a proof: the program's span
``witness.convert``, a median over the window's proofs outside the
profiled stretch."""

from prover_bench.spans import median_span_ms


def read(ctx):
    return median_span_ms(ctx, lambda n: n == "witness.convert")
