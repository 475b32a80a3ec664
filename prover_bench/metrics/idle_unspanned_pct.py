"""The share of the stretch's idle device time that no span of the
program names, in %: of the gaps between device operations
(``Trace.gaps()``), the seconds that no ``za.`` host range other than
the root ``za.prove`` covers, over all their seconds.  A gap is split
by overlap, so a gap half under a span counts half.  None without a
device trace or without the program's ranges in it."""

from prover_bench.spans import overlap_s, union


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    ranges = [(a, b) for n, a, b in tr.host
              if n.startswith("za.") and n != "za.prove"]
    gaps = tr.gaps()
    idle = sum(b - a for a, b in gaps)
    if not ranges or idle <= 0:
        return None
    named = overlap_s([list(g) for g in gaps], union(ranges))
    return 100.0 * (idle - named) / idle
