"""The host's combination of A, B, B1 and C from the MSM results, ms a
proof: the program's span ``combine``, a median over the window's proofs
outside the profiled stretch."""

from prover_bench.spans import median_span_ms


def read(ctx):
    return median_span_ms(ctx, lambda n: n == "combine")
