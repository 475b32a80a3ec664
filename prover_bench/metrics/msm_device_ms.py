"""The five MSMs on the card, ms a proof: the device seconds of the
stage lines msm.g1|g2.tree[...] and .kernel[...], a mean over the
traced proofs outside the profiled stretch."""

from prover_bench.readers import mean_stage


def read(ctx):
    v = mean_stage(ctx, lambda n: n.startswith("msm.")
                   and (".tree[" in n or ".kernel[" in n), 2)
    return None if v is None else 1e3 * v
