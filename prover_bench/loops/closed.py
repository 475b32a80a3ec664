"""The closed loop: one request in flight, the next sent when the last
returns, until the window's seconds have passed.

A traffic file names its loop (``"loop": "closed"``); run.py loads
``prover_bench/loops/<loop>.py`` and calls its ``drive``.  A loop
returns the window's start and one record a request: (index, start,
end), host seconds.
"""

from __future__ import annotations

import time


def drive(traffic: dict, seconds: float, serve) -> tuple[float, list]:
    t0 = time.perf_counter()
    end = t0 + seconds
    recs = []
    i = 0
    while True:
        s = time.perf_counter()
        if s >= end:
            break
        serve(i)
        recs.append((i, s, time.perf_counter()))
        i += 1
    return t0, recs
