"""The readers of the program's spans and counters
(``prover_bench/metrics/<metric>.py`` over ``prover_bench/spans.py``):
hand-made proof records and a hand-made device trace, None where the
run holds nothing to read, and a traced run at a tiny size on the CPU
that reports the six program metrics."""

import json
from pathlib import Path

import pytest

from prover_bench import run
from prover_bench.trace import Trace
from test_harness import tiny_root, tiny_run  # noqa: F401 -- fixture

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = {"witness_convert_ms", "readback_ms", "combine_ms",
           "domain_tables_s", "syncs_per_proof", "h2d_mb_per_proof"}
MS = 1_000_000      # ns


def reader(name):
    return run.Cell(ROOT, BENCH["workloads"][0]["name"]).reader(name)


def _record(i, spans, profiled=False, **counters):
    """A record with a root ``prove`` over [0, 100] ms and the given
    (name, start ms, end ms) spans as its children."""
    sp = [{"name": "prove", "start_ns": 0, "end_ns": 100 * MS,
           "parent": None}]
    sp += [{"name": n, "start_ns": a * MS, "end_ns": b * MS, "parent": 0}
           for n, a, b in spans]
    c = {"syncs": 14, "syncs_timer": 9, "h2d_copies": 1,
         "h2d_bytes": 8_388_800, "d2h_bytes": 577, "launches": 120}
    c.update(counters)
    return {"id": i, "profiled": profiled, "error": None, "spans": sp,
            "counters": c}


def _window(k, profiled=False, syncs=14):
    return _record(k, [("witness.convert", 0, 10 + k),
                       ("msm.g1.readback", 20, 21), ("msm.g1.readback", 30, 31),
                       ("msm.g2.readback", 40, 42), ("combine", 50, 50 + k)],
                   profiled=profiled, syncs=syncs)


@pytest.fixture
def records(monkeypatch):
    """-> set(list): the program's records as recent() gives them."""
    from za_tpu_torch.engine import metrics

    def set_(recs):
        monkeypatch.setattr(metrics, "recent", lambda: list(recs))
    return set_


def test_program_readers_on_hand_made_records(records):
    first = _record(1, [("domain.tables", 5, 2505), ("combine", 60, 61)])
    failed = dict(_window(9, syncs=1000), error="RuntimeError")
    # set-up's first prove, a proof from an earlier run's engine, the
    # window: three proofs, the middle one profiled; a failed prove is
    # not one of the window's proofs
    recs = [_record(0, [("domain.tables", 0, 7000)]), first,
            _window(2), _window(3, profiled=True, syncs=16), failed,
            _window(4, syncs=18)]
    records(recs)
    ctx = {"proofs": [{}] * 3}
    got = {m: reader(m).read(ctx) for m in PROGRAM}
    assert got == {
        "witness_convert_ms": pytest.approx(13.0),   # 12 and 14, not 13's
        "readback_ms": pytest.approx(4.0),
        "combine_ms": pytest.approx(3.0),
        "domain_tables_s": pytest.approx(2.5),       # the latest before
        "syncs_per_proof": 16,
        "h2d_mb_per_proof": pytest.approx(8.3888)}


@pytest.mark.parametrize("case", ["no_records", "no_recent", "no_proofs",
                                  "fewer_records"])
def test_program_readers_read_nothing_without_records(records, monkeypatch,
                                                      case):
    """A run with tracing off keeps no records, and a program without
    ``recent()`` (an older one) none at all: each reader returns None."""
    from za_tpu_torch.engine import metrics

    ctx = {"proofs": [{}] * 2}
    if case == "no_records":
        records([])
    elif case == "no_recent":
        monkeypatch.delattr(metrics, "recent", raising=False)
    elif case == "no_proofs":
        records([_window(1), _window(2)])
        ctx = {"proofs": []}
    else:
        records([_window(1)])
    assert {m: reader(m).read(ctx) for m in PROGRAM} == dict.fromkeys(
        PROGRAM)


def _trace(host):
    # the card busy [0, 1] and [3, 4] s of a [0, 6] s stretch: idle
    # gaps (1, 3) and (4, 6), 4 s
    dev = [("k", 0.0, 1.0), ("k", 3.0, 4.0)]
    return Trace(0.0, 6.0, dev, host)


def test_idle_unspanned_splits_gaps_by_overlap():
    """The first gap is named over 1.7 s of its 2 (a span nested in
    another counted once, one reaching into the card's next op), the
    second not at all; the root za.prove names nothing."""
    host = [("za.prove", 0.0, 6.0), ("bench.prove", 0.0, 6.0),
            ("aten::copy_", 1.0, 3.0),
            ("za.h.z_to_limbs", 0.5, 2.2), ("za.witness.convert", 1.0, 2.0),
            ("za.combine", 2.5, 3.5)]
    got = reader("idle_unspanned_pct").read({"trace": _trace(host)})
    assert got == pytest.approx(100.0 * (4.0 - 1.7) / 4.0)


def test_idle_unspanned_reads_nothing_without_a_trace_or_spans():
    r = reader("idle_unspanned_pct")
    assert r.read({"trace": None}) is None
    # on the CPU: no device operation
    assert r.read({"trace": Trace(0.0, 6.0, [], [("za.combine", 1, 2)])}) \
        is None
    # a program with no span of its own (the root alone names nothing)
    assert r.read({"trace": _trace([("za.prove", 0.0, 6.0),
                                    ("bench.prove", 0.0, 6.0)])}) is None


def test_a_traced_run_reports_the_program_metrics(tiny_root, monkeypatch):  # noqa: F811
    from za_tpu_torch.engine.metrics import StageTimer

    monkeypatch.setattr(StageTimer, "enabled", True)
    monkeypatch.setattr(run, "TRACE_SECONDS", 0.0)
    result, _ = tiny_run(tiny_root, trace=1, seconds="6")
    assert result["correct"]
    got = result["metrics"]
    assert PROGRAM <= set(got)
    assert "idle_unspanned_pct" not in got     # no device on the CPU
    nv = 30 + 2                                # the tiny chain's variables
    assert got["h2d_mb_per_proof"]["value"] == pytest.approx(64 * nv / 1e6)
    # dense at 32 points: the upload, h's flag, 3 + 6 readbacks
    assert got["syncs_per_proof"]["value"] == 11
    for m in BENCH["per_layer"]:
        if m["name"] in got:
            assert got[m["name"]]["unit"] == m["unit"]
