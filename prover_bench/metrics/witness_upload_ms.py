"""The engine's witness upload, ms a proof: the walls of stage lines
h.z_to_limbs (ints to limbs on the host, to the card) and
msm.g1|g2.scalars, a mean over the traced proofs outside the profiled
stretch."""

from prover_bench.readers import mean_stage


def read(ctx):
    v = mean_stage(ctx, lambda n: n == "h.z_to_limbs"
                   or (n.startswith("msm.") and n.endswith(".scalars")), 1)
    return None if v is None else 1e3 * v
