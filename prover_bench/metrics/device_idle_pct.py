"""The card's idle share of a proof, in %: 1 minus a proof's device
busy time over a proof's wall.

The busy time is the union of the device operations' intervals in the
profiled stretch over the proofs made in it (the card's work does not
depend on the profiler).  The wall is the median prove() wall of the
traced proofs outside the stretch, so the profiler's own host work is
not counted as the card's idle time.  Those proofs still carry the
stage timer's wait for the card at each stage's exit (ZA_METRICS)."""

import statistics

from prover_bench.readers import timed_proofs


def read(ctx):
    tr, made = ctx["trace"], len(ctx["stretch"])
    walls = [p["wall"] for p in timed_proofs(ctx)]
    if tr is None or not tr.device or not made or not walls:
        return None
    return 100.0 * (1.0 - tr.busy_s() / made / statistics.median(walls))
