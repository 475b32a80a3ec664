"""The domain's twiddle and scaling tables built on the host and copied
to the card (``ntt.DeviceDomain``), seconds: the program's span
``domain.tables`` in set-up's first prove, the only one that builds
them (the last record before the window that holds the span)."""

from prover_bench.spans import before_window, span_s


def keep(name):
    return name == "domain.tables"


def read(ctx):
    for rec in reversed(before_window(ctx)):
        v = span_s(rec, keep)
        if v is not None:
            return v
    return None
