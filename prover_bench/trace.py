"""The device trace of a traced stretch: ``torch.profiler`` over CPU and
CUDA, read into plain records.

``Trace.device`` holds every operation that ran on the card (kernels,
copies, sets; not the device-side copies of host ranges) as (name,
start, end) in seconds; ``Trace.host`` the host ops and the benchmark's
own ranges (``bench.prove`` around each proof).  Busy time is the
union of the device intervals inside the stretch; an idle gap is a
stretch of time between them, named by the innermost host range that
covers its middle.
"""

from __future__ import annotations

from bisect import bisect_right
from contextlib import contextmanager


class Trace:
    def __init__(self, t0: float, t1: float, device: list, host: list):
        self.t0, self.t1 = t0, t1
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def intervals(self) -> list:
        """The union of the device intervals, clipped to the stretch."""
        out = []
        for _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals())

    def kernel_s(self, patterns) -> float:
        """Device seconds of the operations whose name holds one of
        ``patterns``."""
        return sum(b - a for n, a, b in self.device
                   if any(p in n for p in patterns))

    def top_ops(self, k: int = 10) -> list:
        tot: dict = {}
        for n, a, b in self.device:
            name = short(n)
            tot[name] = tot.get(name, 0.0) + (b - a)
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda e: -e[1])[:k]

    def gaps(self) -> list:
        """Idle stretches between device operations: (start, end)."""
        out, t = [], self.t0
        for a, b in self.intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def top_gaps(self, k: int = 10) -> list:
        """The k longest gaps, each named by the innermost host range
        covering its middle and the host op that ended last before it."""
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        out = []
        for a, b in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:k]:
            mid = (a + b) / 2
            inner = last = None
            for n, s, e in host[:bisect_right(starts, mid)]:
                if s <= mid <= e and (inner is None or e - s < inner[1]):
                    inner = (n, e - s)
                if e <= a + 1e-6 and not n.startswith("bench.") and (
                        last is None or e > last[1]):
                    last = (n, e)
            name = inner[0] if inner else "(no host op)"
            if last is not None:
                name += f" after {last[0]}"
            out.append([name[:160], b - a])
        return out


def short(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[:160]


@contextmanager
def traced(device_kind: str):
    """``with traced(...) as box:`` profiles the block; box["trace"] is
    the Trace once it has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device_kind == "cuda":
        acts.append(ProfilerActivity.CUDA)
    box: dict = {}
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            yield box
            if device_kind == "cuda":
                torch.cuda.synchronize()
    dev, host = [], []
    t0 = t1 = None
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # not the device-side copy of a host range
            if not (e.is_user_annotation() or rec[0].startswith("bench.")):
                dev.append(rec)
        elif rec[0] == STRETCH:
            t0, t1 = rec[1], rec[2]
        else:
            host.append(rec)
    box["trace"] = Trace(t0, t1, dev, host)


STRETCH = "bench.stretch"
