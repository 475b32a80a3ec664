"""The share of witness values the upload converted in its native pass,
in %: 100 x the program's counter ``witness_native`` over
``witness_native`` + ``witness_fallback`` (values reduced in Python), a
median over the window's proofs that uploaded a witness; None on a
program without the counters."""

import statistics

from prover_bench.spans import window


def read(ctx):
    per = []
    for rec in window(ctx):
        c = rec.get("counters", {})
        n = c.get("witness_native", 0) + c.get("witness_fallback", 0)
        if "witness_native" in c and n:
            per.append(100.0 * c["witness_native"] / n)
    return statistics.median(per) if per else None
