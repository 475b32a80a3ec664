"""The engine's instrumentation: spans, per-proof records and counters,
and the ``[stage] <name>: <wall>s`` log lines.

One span class (``Span``) has three outputs, each with its own switch:

* **Profiler range.**  While a ``torch.profiler`` (or autograd
  profiler) records, a span opens ``record_function("za.<name>")``, so
  its range lies on the device trace's own clock: a trace names the
  card's idle gaps by what the host was doing.
* **Proof record.**  ``prove()`` opens the root span ``prove``
  (``ProofSpan``), which starts a record while tracing is on: the timer's
  switch (``StageTimer.enabled``: ``ZA_METRICS`` set and not "0", ``za
  -v``) or a recording profiler.  Every span opened inside it lands in
  the record: name, start and end (``time.perf_counter_ns``) and its
  parent, an index into the record's spans (None for the root).  A
  record holds ``id`` (the process's count of ``prove()`` calls: the
  ranks of a mesh prove the same sequence, so ids join across ranks),
  ``profiled`` (whether a profiler recorded during it), ``error`` (the
  exception's type name, or None), ``spans`` and ``counters``.  Closed
  records sit in a ring of the last ``RING``, ``recent()``.  One proof
  is open at a time in a process.
* **Stage line.**  ``StageTimer`` and ``StageParts`` (and each of its
  parts) are spans that also log, with the timer's switch on, one line to
  the logger ``za_tpu_torch.metrics`` at INFO; a plain ``Span`` logs
  none.  With the switch on, each proof also logs ``[proof] id=<n>
  wall=<s>s syncs=<n> h2d=<MB>MB d2h=<MB>MB launches=<n>
  witness_native=<n> witness_fallback=<n>``.

On a CUDA device a stage records a ``torch.cuda.Event`` pair on the
current stream and, at its exit, waits for the end event and adds the
device seconds between the two: ``[stage] <name>: <wall>s device
<dev>s``.  The device seconds are the card's time between the two
events, idle time included: where the host issues more slowly than the
card runs (host loops, a process's first launch of a kernel) they come
near the wall.  On the CPU it logs wall seconds only.

On, each stage waits for the card once at its exit, as the reference's
timer does.  That serializes what would overlap otherwise: staging's
host work on the next block against the card's work on the last
(``GpuEngine._stage``), and the host's issue of the next stage against
the card's run of this one; the card waits out the host's time between
two stages, which no stage's device seconds hold.

Counters of the open record, counted where the work happens by the
helpers below: ``syncs`` (the host's waits for the card, as torch's sync
debug mode counts them: a pageable copy either way, ``bool()`` of a
device tensor, ``synchronize``, an event waited for), ``syncs_timer``
(the stage timer's own waits, apart), ``h2d_copies``, ``h2d_bytes``
(a copy from pinned memory, which the host does not wait for, too),
``d2h_bytes``, ``launches`` (the change over the proof in the kernel
wrappers' own ``_build.Kernel.launches``), and the witness values the
upload converted in its native pass, ``witness_native``, or reduced in
Python, ``witness_fallback``, and the nonzero 4-bit digits of those
values mod r, ``witness_digits`` (of 64 digit slots a value: the digits
the MSM's signed windows follow up to their carries).  A copy, read or
wait is counted where the program makes it, on every device, so an
engine on the CPU counts what the same calls make on the card;
``synchronize`` and the timer's waits count only on a card, where they
run.

Off (no switch, no profiler), a span checks the switch and the profiler
and does nothing else: no event, no record, no range, no wait, no line;
a counter helper checks for an open record.  The switch is read from
``ZA_METRICS`` once, when this module is imported.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque

import torch
from torch.profiler import record_function

from . import _build

log = logging.getLogger("za_tpu_torch.metrics")

#: proof records ``recent()`` keeps (a 51 s window at 2^17 makes ~400)
RING = 4096

COUNTERS = ("syncs", "syncs_timer", "h2d_copies", "h2d_bytes", "d2h_bytes",
            "launches", "witness_native", "witness_fallback",
            "witness_digits")

#: whether a torch profiler records now
_profiling = torch._C._autograd._profiler_enabled


class _Recorder:
    """The process's proof records: the open one, its stack of open spans
    and the closed ones."""

    def __init__(self):
        self.ring: deque = deque(maxlen=RING)
        self.proof: dict | None = None
        self.stack: list = []
        self.proofs = 0         # prove() calls made, traced or not


_REC = _Recorder()


def recent() -> list:
    """The closed proof records, oldest first (at most RING)."""
    return list(_REC.ring)


def _launches() -> int:
    return sum(k.launches for k in _build.KERNELS.values())


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _event_pair():
    a = torch.cuda.Event(enable_timing=True)
    a.record()
    return a, torch.cuda.Event(enable_timing=True)


# -- spans ----------------------------------------------------------------------


class Span:
    """``with Span(name):`` a range under a profiler and a span of the
    open proof record while tracing is on; nothing otherwise."""

    def __init__(self, name: str):
        self.name = name
        self.on = False

    def __enter__(self):
        self.on = StageTimer.enabled or _profiling()
        if self.on:
            self._open()
        return self

    def __exit__(self, exc_type, *exc):
        if self.on:
            self._close()

    def _open(self) -> None:
        self._range = None
        if _profiling():
            self._range = record_function("za." + self.name)
            self._range.__enter__()
        self._rec = rec = _REC.proof
        self.t0 = time.perf_counter_ns()
        if rec is None:
            return
        if self._range is not None:
            rec["profiled"] = True
        stack, spans = _REC.stack, rec["spans"]
        self._index = len(spans)
        spans.append({"name": self.name, "start_ns": self.t0,
                      "end_ns": None,
                      "parent": stack[-1] if stack else None})
        stack.append(self._index)

    def _close(self) -> int:
        """Ends the span -> its end (perf_counter_ns)."""
        t1 = time.perf_counter_ns()
        if self._rec is not None:
            self._rec["spans"][self._index]["end_ns"] = t1
            _REC.stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return t1


class ProofSpan(Span):
    """``with ProofSpan():`` around one ``prove()`` call: the root span
    ``prove``, which starts the proof's record, closes it into the ring
    with its counters, and logs the ``[proof]`` line."""

    def __init__(self):
        super().__init__("prove")

    def __enter__(self):
        _REC.proofs += 1
        self.on = StageTimer.enabled or _profiling()
        if self.on:
            _REC.proof = {"id": _REC.proofs, "profiled": bool(_profiling()),
                          "error": None, "spans": [],
                          "counters": dict.fromkeys(COUNTERS, 0)}
            _REC.stack = []
            self._launch0 = _launches()
            self._open()
        return self

    def __exit__(self, exc_type, *exc):
        if not self.on:
            return
        t1 = self._close()
        rec = self._rec
        c = rec["counters"]
        c["launches"] = _launches() - self._launch0
        rec["error"] = None if exc_type is None else exc_type.__name__
        rec["profiled"] = rec["profiled"] or bool(_profiling())
        _REC.proof, _REC.stack = None, []
        _REC.ring.append(rec)
        if StageTimer.enabled:
            log.info("[proof] id=%d wall=%.6fs syncs=%d h2d=%.6fMB "
                     "d2h=%.6fMB launches=%d witness_native=%d "
                     "witness_fallback=%d", rec["id"],
                     (t1 - self.t0) / 1e9, c["syncs"], c["h2d_bytes"] / 1e6,
                     c["d2h_bytes"] / 1e6, c["launches"],
                     c["witness_native"], c["witness_fallback"])


class StageTimer(Span):
    """``with StageTimer(name, device):`` a span that logs the block's
    seconds, with the switch on."""

    enabled = os.environ.get("ZA_METRICS", "0") != "0"

    def __init__(self, name: str, device=None):
        super().__init__(name)
        self.device = device

    def __enter__(self):
        super().__enter__()
        self.line = StageTimer.enabled
        if self.line:
            self.events = _event_pair() if _on_cuda(self.device) else None
        return self

    def __exit__(self, exc_type, *exc):
        if not self.on:
            return
        if not self.line or exc_type is not None:
            self._close()
            return
        if self.events is None:
            wall = (self._close() - self.t0) / 1e9
            log.info("[stage] %s: %.6fs", self.name, wall)
            return
        a, b = self.events
        b.record()
        b.synchronize()
        count_timer_sync()
        wall = (self._close() - self.t0) / 1e9
        log.info("[stage] %s: %.6fs device %.6fs", self.name, wall,
                 a.elapsed_time(b) / 1e3)


class StageParts(Span):
    """Totals of named parts over the blocks of one call, one line:
    ``[stage] <name>: <part> <wall>s[ device <dev>s], ...``.  A part's
    wall is the host's time in it, which waits for the card only where
    the part itself does (a copy from the host); its device seconds are
    the card's between the part's two events.  The card is waited for
    once, at the exit.  Each part is a span, ``<name>.<part>`` without
    the name's brackets."""

    def __init__(self, name: str, device=None):
        super().__init__(name)
        self.device = device

    def __enter__(self):
        super().__enter__()
        self.line = StageTimer.enabled
        self.parts: dict = {}
        return self

    def part(self, name: str) -> "_Part":
        return _Part(self, name)

    def __exit__(self, exc_type, *exc):
        if not self.on:
            return
        if not self.line or exc_type is not None:
            self._close()
            return
        cuda = _on_cuda(self.device)
        if cuda:
            torch.cuda.current_stream().synchronize()
            count_timer_sync()
        self._close()
        fields = []
        for name, (wall, pairs) in self.parts.items():
            text = f"{name} {wall:.6f}s"
            if cuda:
                dev = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
                text += f" device {dev:.6f}s"
            fields.append(text)
        log.info("[stage] %s: %s", self.name, ", ".join(fields))


class _Part(Span):
    def __init__(self, parts: StageParts, name: str):
        super().__init__(f"{parts.name.split('[')[0]}.{name}")
        self.parts, self.part = parts, name

    def __enter__(self):
        super().__enter__()
        if self.on and self.parts.line:
            self.events = (_event_pair() if _on_cuda(self.parts.device)
                           else None)
        return self

    def __exit__(self, exc_type, *exc):
        if not self.on:
            return
        t1 = self._close()
        if not self.parts.line:
            return
        wall, pairs = self.parts.parts.get(self.part, (0.0, []))
        if self.events is not None:
            self.events[1].record()
            pairs = pairs + [self.events]
        self.parts.parts[self.part] = (wall + (t1 - self.t0) / 1e9, pairs)


# -- counters --------------------------------------------------------------------


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor -> its copy on ``device``: a pageable copy, which the
    host waits out; counted as a copy, its bytes and a sync."""
    rec = _REC.proof
    if rec is not None:
        c = rec["counters"]
        c["h2d_copies"] += 1
        c["h2d_bytes"] += t.nbytes
        c["syncs"] += 1
    return t.to(device)


def to_device_async(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor -> its copy on ``device``, queued on the current
    stream (``non_blocking``; from pinned memory the host goes on at
    once): counted as a copy and its bytes, not as a sync."""
    rec = _REC.proof
    if rec is not None:
        c = rec["counters"]
        c["h2d_copies"] += 1
        c["h2d_bytes"] += t.nbytes
    return t.to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A device tensor -> its copy on the host (``.cpu()``): counted as
    its bytes and a sync."""
    rec = _REC.proof
    if rec is not None:
        c = rec["counters"]
        c["d2h_bytes"] += t.nbytes
        c["syncs"] += 1
    return t.cpu()


def host_bool(t: torch.Tensor) -> bool:
    """``bool()`` of a one-element device tensor: a read the host waits
    for, counted as its bytes and a sync."""
    count_sync(t.element_size())
    return bool(t)


def count_sync(d2h_bytes: int = 0) -> None:
    """One read of the host from the card inside a torch call (such as
    ``torch.equal``'s flag), ``d2h_bytes`` long."""
    rec = _REC.proof
    if rec is not None:
        c = rec["counters"]
        c["d2h_bytes"] += d2h_bytes
        c["syncs"] += 1


def synchronize(device) -> None:
    """``torch.cuda.synchronize(device)``, counted as a sync."""
    rec = _REC.proof
    if rec is not None:
        rec["counters"]["syncs"] += 1
    torch.cuda.synchronize(device)


def wait(event: torch.cuda.Event) -> None:
    """``event.synchronize()``, counted as a sync."""
    rec = _REC.proof
    if rec is not None:
        rec["counters"]["syncs"] += 1
    event.synchronize()


def recording() -> bool:
    """Whether a proof record is open: a counter that costs work of its
    own to count (``witness_digits``) is counted only then."""
    return _REC.proof is not None


def count_witness(native: int, fallback: int, digits: int | None) -> None:
    """Witness values converted by the upload's native pass and reduced
    in Python, and their nonzero 4-bit digits (None: not counted, with
    no record open)."""
    rec = _REC.proof
    if rec is not None:
        c = rec["counters"]
        c["witness_native"] += native
        c["witness_fallback"] += fallback
        c["witness_digits"] += digits


def count_timer_sync() -> None:
    """One wait of the stage timer for the card."""
    rec = _REC.proof
    if rec is not None:
        rec["counters"]["syncs_timer"] += 1
