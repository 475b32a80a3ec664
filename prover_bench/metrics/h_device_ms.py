"""h(x) on the card, ms a proof: the device seconds of the stage lines
h.csr, h.matvec, h.ntt.*, h.combine+intt, h.to_scalars (every h.* line
but the witness upload), a mean over the traced proofs outside the profiled
stretch."""

from prover_bench.readers import mean_stage


def read(ctx):
    v = mean_stage(ctx, lambda n: n.startswith("h.")
                   and n != "h.z_to_limbs", 2)
    return None if v is None else 1e3 * v
