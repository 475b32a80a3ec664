"""What the metric readers (``prover_bench/metrics/<metric>.py``) share.

A reader is a module with ``read(ctx) -> float | None``; None when the
run holds nothing for it to read, and the metric is then left out of
the result line.  ``ctx`` (built by run.py):
- ``setup``: set-up parts in seconds (``imports_s``, ``inputs_s``,
  ``build_s``, ``program_s``, ``stage_s``, ``first_prove_s``,
  ``setup_s``);
- ``window``: ``seconds`` (start to the last request's end), ``records``
  (index, start, end) of the requests that returned a proof;
- ``proofs``: a dict a returned proof: ``witness`` (its index),
  ``wall`` (the prove() call's seconds), ``stretch`` (whether it ran
  under the profiler) and, in a traced run, ``lines``: the engine's
  stage lines (name, wall s, device s or None) of the proof;
- ``trace``: the device trace of the traced stretch (trace.Trace) or
  None; ``stretch``: the witness index of each proof inside it;
- ``circuit``, ``witnesses``, ``peaks``, ``memory_peak_bytes``, and
  ``work(layer)``: the module ``prover_bench/work/<layer>.py``.
"""

from __future__ import annotations

import statistics


def timed_proofs(ctx) -> list:
    """The proofs with stage lines and outside the profiled stretch
    (the profiler slows the host); empty outside a traced run."""
    return [p for p in ctx["proofs"] if p["lines"] and not p["stretch"]]


def mean_stage(ctx, keep, field: int) -> float | None:
    """Mean over the timed proofs of the summed ``field`` (1 wall, 2
    device) of the stage lines whose name ``keep`` accepts."""
    per = []
    for p in timed_proofs(ctx):
        vals = [ln[field] for ln in p["lines"] if keep(ln[0])]
        if not vals or any(v is None for v in vals):
            return None
        per.append(sum(vals))
    return statistics.fmean(per) if per else None


def least_time(work: dict, peaks: dict) -> float:
    """The least seconds for ``work`` ({"ops", "bytes"}) on the card:
    the larger of its multiply-adds at the INT32 lanes' rate (SMs x
    lanes x clock) and its bytes at HBM's rate."""
    rate = peaks["sms"] * peaks["int32_lanes_per_sm"] * peaks["clock_hz"]
    return max(work["ops"] / rate, work["bytes"] / peaks["hbm_bytes_per_s"])


def least_s(ctx, layer: str) -> float | None:
    """The least seconds of ``layer``'s work over the stretch's proofs."""
    if ctx["trace"] is None or not ctx["stretch"]:
        return None
    mod = ctx["work"](layer)
    per = {}
    for k in set(ctx["stretch"]):
        per[k] = least_time(mod.work(ctx["circuit"], ctx["witnesses"][k],
                                     ctx["peaks"]), ctx["peaks"])
    return sum(per[k] for k in ctx["stretch"])


def roofline_pct(ctx, layer: str) -> float | None:
    """100 x the least time of the layer's work over the device seconds
    of its kernels, both over the traced stretch."""
    least = least_s(ctx, layer)
    if least is None:
        return None
    dev = ctx["trace"].kernel_s(ctx["work"](layer).KERNELS)
    return 100.0 * least / dev if dev > 0 else None
