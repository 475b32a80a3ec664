#!/usr/bin/env python3
"""Where a warm prove's time goes on one CUDA card, by the port's spans
(za_tpu_torch/engine/metrics.py): the benchmark's chain at 2^k, its
set-up profiled, steady proofs timed, recorded and profiled.

    python3 tools/torch_prove_spans.py [--log2n 17] [--proofs 8]
                                       [--seed 3] [--out FILE]

Inputs are prover_bench's (circuit, pool proving key with known logs,
witnesses from the seed); the prover is ``prover_bench.program``'s.
Prints JSON lines (and writes them to --out):
  {"setup": ...}: staging and the first prove under torch.profiler
    (CPU and CUDA, timer off): the set-up's and the first prove's wall
    split by span (self seconds of each ``za.`` range), and the host ops
    and CUDA runtime calls of the whole set-up with the most self time,
    each with the innermost span of its longest call;
  {"steady": ...}: proofs with tracing off (walls), with the stage
    timer on (the records: counters, the ``[proof]`` line's numbers,
    span walls), and under the profiler with the timer off: each
    proof's idle device time split by innermost span (the root
    ``prove`` alone: unspanned), and its ``Memcpy HtoD`` operations
    against the record's ``h2d_copies`` (one proof more is profiled
    first and left out: CUPTI starts recording the card late);
  {"sync_debug": ...}: one proof under torch.cuda.set_sync_debug_mode
    ("warn"), its warnings against the record's ``syncs``;
  {"span_cost": ...}: a span entered and left with tracing off, and on
    outside a proof, beside an empty context manager and an empty call,
    in ns (median of 5 x 200k);
  {"card": ...}: the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
import timeit
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def emit(out, obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        with open(out, "a", encoding="utf-8") as f:
            f.write(line + "\n")


def profiled(fn):
    """fn() under torch.profiler (CPU and CUDA) -> (its result, device
    ops, host events, each (name, start s, end s), the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(rec)
        else:
            host.append(rec)
    return out, dev, host, prof


def za_ranges(host):
    return [h for h in host if h[0].startswith("za.")]


def innermost(ranges, a, b):
    """The shortest za. range covering [a, b], its name without "za."."""
    best = None
    for n, s, e in ranges:
        if s <= a and b <= e and (best is None or e - s < best[2] - best[1]):
            best = (n, s, e)
    return best[0][3:] if best else "(no span)"


def split_by_span(ranges, a, b, acc):
    """[a, b] cut at every range's ends, each piece added to acc under
    its innermost range."""
    cuts = sorted({a, b} | {t for _, s, e in ranges for t in (s, e)
                            if a < t < b})
    for x, y in zip(cuts, cuts[1:]):
        name = innermost(ranges, x, y)
        acc[name] = acc.get(name, 0.0) + (y - x)


def self_times(ranges, a, b):
    """Each span's self seconds inside [a, b]: its time that no inner
    span covers."""
    acc = {}
    split_by_span(ranges, a, b, acc)
    return acc


def union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(dev, host):
    """Per za.prove range: idle device time split by innermost span, and
    the Memcpy HtoD operations that start inside it."""
    ranges = za_ranges(host)
    busy = union([(a, b) for _, a, b in dev])
    out = []
    for _, p0, p1 in (r for r in ranges if r[0] == "za.prove"):
        inside = [r for r in ranges if p0 <= r[1] and r[2] <= p1]
        acc, t = {}, p0
        for a, b in busy:
            a, b = max(a, p0), min(b, p1)
            if b <= a:
                continue
            if a > t:
                split_by_span(inside, t, a, acc)
            t = max(t, b)
        if p1 > t:
            split_by_span(inside, t, p1, acc)
        h2d = sum(1 for n, a, _ in dev if "Memcpy HtoD" in n
                  and p0 <= a <= p1)
        out.append({"wall_s": p1 - p0, "idle_s": sum(acc.values()),
                    "idle_by_span": dict(sorted(acc.items(),
                                                key=lambda kv: -kv[1])),
                    "memcpy_htod": h2d})
    return out


def top_self(prof, host, ranges, k=15):
    """The host ops with the most self time (the profile's own sums), each
    with its calls and the innermost span of its longest event."""
    longest = {}
    for n, a, b in host:
        if n not in longest or b - a > longest[n][1] - longest[n][0]:
            longest[n] = (a, b)
    rows = sorted((e for e in prof.key_averages()
                   if not e.key.startswith("za.")),
                  key=lambda e: -e.self_cpu_time_total)[:k]
    out = []
    for e in rows:
        a, b = longest.get(e.key, (0.0, 0.0))
        out.append({"op": e.key[:120], "self_s": e.self_cpu_time_total / 1e6,
                    "calls": e.count, "longest_s": b - a,
                    "span": innermost(ranges, a, b)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--log2n", type=int, default=17)
    p.add_argument("--proofs", type=int, default=8)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from prover_bench import inputs, program
    from prover_bench.circuits import chain
    from za_tpu_torch.engine import metrics

    metrics.StageTimer.enabled = False
    cfg = {"constraints": 1 << args.log2n}
    circuit = chain.rows(cfg)
    W = 4
    wits = inputs.witness_pool(chain, cfg, args.seed, W)
    pk = inputs.proving_key(circuit, inputs.proving_key_logs(args.seed))
    program.build_kernels()
    rc, prm = program.r1cs(circuit), program.params(pk)
    del pk
    eng = program.GpuEngine()
    rs = inputs.Randomness(args.seed)

    def prove(i):
        r, s = rs.next()
        return program.prove_once(prm, rc, list(wits[i % W]), r, s, eng)

    # -- set-up: staging and the first prove, profiled
    t0 = time.perf_counter()

    def setup():
        eng.stage_params(prm, rc)
        t = time.perf_counter()
        prove(0)
        return time.perf_counter() - t
    first_s, dev, host, prof = profiled(setup)
    ranges = za_ranges(host)
    root = [r for r in ranges if r[0] == "za.prove"][0]
    emit(args.out, {"setup": {
        "log2n": args.log2n, "wall_s": time.perf_counter() - t0,
        "first_prove_s": first_s,
        "setup_by_span": self_times(ranges, min(r[1] for r in ranges),
                                    max(r[2] for r in ranges)),
        "first_prove_by_span": self_times(
            [r for r in ranges if root[1] <= r[1] and r[2] <= root[2]],
            root[1], root[2]),
        "top_host_ops": top_self(prof, host, ranges),
        "device_busy_s": sum(b - a for a, b in union(
            [(a, b) for _, a, b in dev]))}})

    # -- steady proofs: off, timer on (records), profiled
    for i in range(2):
        prove(i)
    walls = []
    for i in range(args.proofs):
        t = time.perf_counter()
        prove(i)
        walls.append(time.perf_counter() - t)
    metrics.StageTimer.enabled = True
    n0 = len(metrics.recent())
    on_walls = []
    for i in range(args.proofs):
        t = time.perf_counter()
        prove(i)
        on_walls.append(time.perf_counter() - t)
    recs = metrics.recent()[n0:]
    metrics.StageTimer.enabled = False

    def span_ms(rec):
        acc = {}
        for s in rec["spans"]:
            acc[s["name"]] = acc.get(s["name"], 0.0) + (
                s["end_ns"] - s["start_ns"]) / 1e6
        return acc
    names = sorted({n for r in recs for n in span_ms(r)})
    med = {n: statistics.median(span_ms(r).get(n, 0.0) for r in recs)
           for n in names}
    n1 = len(metrics.recent())
    _, dev, host, _ = profiled(
        lambda: [prove(i) for i in range(args.proofs + 1)])
    precs = metrics.recent()[n1 + 1:]
    per = idle_by_span(dev, host)[1:]
    for row, rec in zip(per, precs):
        row["h2d_copies"] = rec["counters"]["h2d_copies"]
        row["syncs"] = rec["counters"]["syncs"]
    idle = {}
    for row in per:
        for k, v in row["idle_by_span"].items():
            idle.setdefault(k, []).append(v)
    emit(args.out, {"steady": {
        "log2n": args.log2n, "proofs": args.proofs,
        "wall_off_s": walls, "wall_off_median_s": statistics.median(walls),
        "wall_timer_median_s": statistics.median(on_walls),
        "counters": [r["counters"] for r in recs],
        "span_median_ms": med,
        "profiled": per,
        "idle_median_by_span_s": {k: statistics.median(v)
                                  for k, v in sorted(
                                      idle.items(),
                                      key=lambda kv: -sum(kv[1]))},
        "memcpy_equals_h2d_copies": all(
            r["memcpy_htod"] == r["h2d_copies"] for r in per)}})

    # -- the sync debug mode against the record, timer off (a CPU
    # profiler turns the record on)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                prove(1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    rec = metrics.recent()[-1]
    emit(args.out, {"sync_debug": {
        "log2n": args.log2n,
        "warnings": sum("synchroniz" in str(w.message) for w in got),
        "record_syncs": rec["counters"]["syncs"],
        "record": rec["counters"]}})

    # -- a span's own cost
    def timed(fn, n=200_000):
        return statistics.median(timeit.timeit(fn, number=n) / n * 1e9
                                 for _ in range(5))

    def span():
        with metrics.Span("x"):
            pass

    class Empty:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    def empty():
        with Empty():
            pass
    off_ns = timed(span)
    metrics.StageTimer.enabled = True
    on_ns = timed(span)
    metrics.StageTimer.enabled = False
    emit(args.out, {"span_cost": {"off_ns": off_ns, "on_no_proof_ns": on_ns,
                                  "empty_with_ns": timed(empty),
                                  "empty_call_ns": timed(lambda: None)}})
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "nvidia-smi: not read"
    emit(args.out, {"card": card, "torch": torch.__version__})
    return 0


if __name__ == "__main__":
    sys.exit(main())
