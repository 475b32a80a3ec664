"""The share of the witness MSMs' digit slots that are live, in %: 100 x
the program's counter ``witness_digits`` (nonzero 4-bit digits of the
uploaded witness values mod r) over 64 slots a value, ``witness_native``
+ ``witness_fallback`` values, a median over the window's proofs that
uploaded a witness; None on a program without the counter.  The tree MSM
sums every slot whatever its digit; a full-width witness reads ~93%, a
witness of bits ~1%."""

import statistics

from prover_bench.spans import window

SLOTS = 64


def read(ctx):
    per = []
    for rec in window(ctx):
        c = rec.get("counters", {})
        n = c.get("witness_native", 0) + c.get("witness_fallback", 0)
        if "witness_digits" in c and n:
            per.append(100.0 * c["witness_digits"] / (SLOTS * n))
    return statistics.median(per) if per else None
