"""The 95th percentile over all the window's proofs of one prove()
call's seconds, from the call's start to the proof's return (host
clock)."""

import statistics


def read(ctx):
    lat = [end - start for _, start, end in ctx["window"]["records"]]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
