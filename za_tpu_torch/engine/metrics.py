"""Per-stage metrics of the engine: ``[stage] <name>: <wall>s`` log lines.

The port's counterpart of the reference's ``_StageTimer``
(za_tpu/engine/engine.py:30-60).  Off unless ``ZA_METRICS`` is set and
not "0" (``za -v`` sets it before the engine is imported); the variable
is read once, when this module is imported.  Lines go to the logger
``za_tpu_torch.metrics`` at INFO.

On a CUDA device a stage records a ``torch.cuda.Event`` pair on the
current stream and, at its exit, waits for the end event and adds the
device seconds between the two: ``[stage] <name>: <wall>s device
<dev>s``.  The device seconds are the card's time between the two
events, idle time included: where the host issues more slowly than the
card runs (host loops, a process's first launch of a kernel) they come
near the wall.  On the CPU it logs wall seconds only.  Off, it creates
no event, waits for nothing and logs nothing.

On, each stage waits for the card once at its exit, as the reference's
timer does.  That serializes what would overlap otherwise: staging's
host work on the next block against the card's work on the last
(``GpuEngine._stage``), and the host's issue of the next stage against
the card's run of this one; the card waits out the host's time between
two stages, which no stage's device seconds hold.
"""

from __future__ import annotations

import logging
import os
import time

import torch

log = logging.getLogger("za_tpu_torch.metrics")


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _event_pair():
    a = torch.cuda.Event(enable_timing=True)
    a.record()
    return a, torch.cuda.Event(enable_timing=True)


class StageTimer:
    """``with StageTimer(name, device):`` logs the block's seconds."""

    enabled = os.environ.get("ZA_METRICS", "0") != "0"

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.on = False

    def __enter__(self):
        self.on = self.enabled
        if self.on:
            self.events = _event_pair() if _on_cuda(self.device) else None
            self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, *exc):
        if not self.on or exc_type is not None:
            return
        if self.events is None:
            log.info("[stage] %s: %.6fs", self.name,
                     time.monotonic() - self.t0)
            return
        a, b = self.events
        b.record()
        b.synchronize()
        log.info("[stage] %s: %.6fs device %.6fs", self.name,
                 time.monotonic() - self.t0, a.elapsed_time(b) / 1e3)


class StageParts:
    """Totals of named parts over the blocks of one call, one line:
    ``[stage] <name>: <part> <wall>s[ device <dev>s], ...``.  A part's
    wall is the host's time in it, which waits for the card only where
    the part itself does (a copy from the host); its device seconds are
    the card's between the part's two events.  The card is waited for
    once, at the exit."""

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.on = False

    def __enter__(self):
        self.on = StageTimer.enabled
        self.parts: dict = {}
        return self

    def part(self, name: str) -> "_Part":
        return _Part(self, name)

    def __exit__(self, exc_type, *exc):
        if not self.on or exc_type is not None:
            return
        cuda = _on_cuda(self.device)
        if cuda:
            torch.cuda.current_stream().synchronize()
        fields = []
        for name, (wall, pairs) in self.parts.items():
            text = f"{name} {wall:.6f}s"
            if cuda:
                dev = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
                text += f" device {dev:.6f}s"
            fields.append(text)
        log.info("[stage] %s: %s", self.name, ", ".join(fields))


class _Part:
    def __init__(self, parts: StageParts, name: str):
        self.parts, self.name = parts, name

    def __enter__(self):
        if self.parts.on:
            self.events = (_event_pair() if _on_cuda(self.parts.device)
                           else None)
            self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        if not self.parts.on:
            return
        wall, pairs = self.parts.parts.get(self.name, (0.0, []))
        if self.events is not None:
            self.events[1].record()
            pairs = pairs + [self.events]
        self.parts.parts[self.name] = (wall + time.monotonic() - self.t0,
                                       pairs)
