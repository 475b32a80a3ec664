"""What the readers of the program's spans and counters share.

The port keeps a record of each ``prove()`` call while tracing is on
(``za_tpu_torch.engine.metrics.recent()``): ``id``, ``profiled``,
``error``, ``spans`` (``name``, ``start_ns``, ``end_ns``, ``parent``)
and ``counters``.  A traced run (``ZA_METRICS=1``) records every proof;
the window's are the last records, one a proof the window returned.  A
program that keeps no records gives the readers nothing, and each
returns None.
"""

from __future__ import annotations

import statistics


def _all(ctx) -> list:
    """The program's records of proofs that returned, oldest first; []
    where the program keeps none."""
    try:
        from za_tpu_torch.engine import metrics
    except ImportError:
        return []
    recent = getattr(metrics, "recent", None)
    if recent is None:
        return []
    return [r for r in recent() if r.get("error") is None]


def window(ctx) -> list:
    """The records of the window's proofs: the last, one a proof."""
    recs, n = _all(ctx), len(ctx["proofs"])
    return recs[-n:] if n and len(recs) >= n else []


def before_window(ctx) -> list:
    """The records made before the window (set-up's proofs last)."""
    recs, n = _all(ctx), len(ctx["proofs"])
    return recs[:-n] if n and len(recs) >= n else []


def span_s(rec: dict, keep) -> float | None:
    """Seconds of the record's spans whose name ``keep`` accepts, summed;
    None where it has none."""
    got = [s["end_ns"] - s["start_ns"] for s in rec["spans"]
           if keep(s["name"])]
    return sum(got) / 1e9 if got else None


def median_span_ms(ctx, keep) -> float | None:
    """Median over the window's proofs outside the profiled stretch (the
    profiler slows the host) of span_s, in ms."""
    per = [span_s(r, keep) for r in window(ctx) if not r["profiled"]]
    per = [v for v in per if v is not None]
    return 1e3 * statistics.median(per) if per else None


def median_counter(ctx, name: str) -> float | None:
    """Median over the window's proofs of one counter (counts do not
    depend on the profiler, so the stretch's proofs count too)."""
    per = [r["counters"][name] for r in window(ctx)
           if name in r.get("counters", {})]
    return statistics.median(per) if per else None


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_s(xs, ys) -> float:
    """Seconds where two lists of sorted disjoint intervals overlap."""
    i = j = 0
    tot = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot
