"""Proofs completed in the window over the window's seconds: all the
work over all the time, from the window's start to the last proof's
return (host clock)."""


def read(ctx):
    w = ctx["window"]
    return len(w["records"]) / w["seconds"] if w["records"] else None
