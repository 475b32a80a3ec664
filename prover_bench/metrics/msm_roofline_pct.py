"""The MSM kernels against their roofline: the least time of the work
counted from the inputs (prover_bench/work/msm.py) over the device time
of the MSM kernels by name in the device trace, over the traced
stretch, in %."""

from prover_bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "msm")
