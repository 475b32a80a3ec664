"""h(x)'s kernels against their roofline: the least time of the work
counted from the inputs (prover_bench/work/h.py) over the device time
of the h(x) kernels by name in the device trace, over the traced
stretch, in %."""

from prover_bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "h")
