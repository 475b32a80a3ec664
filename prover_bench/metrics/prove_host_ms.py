"""A proof's prove() wall minus the walls of the engine's stage lines
(the prover's host work outside every stage: the host combination of
the points, the points' readback and conversion), ms, a mean over the
traced proofs outside the profiled stretch."""

import statistics

from prover_bench.readers import timed_proofs


def read(ctx):
    per = [p["wall"] - sum(ln[1] for ln in p["lines"])
           for p in timed_proofs(ctx)]
    return 1e3 * statistics.fmean(per) if per else None
