"""The five MSM results read back to the host and made affine there, ms a
proof: the program's spans ``msm.g1.readback`` and ``msm.g2.readback``
summed, a median over the window's proofs outside the profiled
stretch."""

from prover_bench.spans import median_span_ms


def read(ctx):
    return median_span_ms(ctx, lambda n: n.startswith("msm.")
                          and n.endswith(".readback"))
