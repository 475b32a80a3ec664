"""The prover's spans and counters (za_tpu_torch/engine/metrics.py) on the
CPU: a GpuEngine(device="cpu") proof from the 30-constraint chain's pk
(tests/torch_chain_pk.py, the staged gate lowered to its size), dense
and tree.  With tracing on (the stage timer's switch, or a recording
profiler) every proof leaves one record: one ``prove`` root with an id,
each span inside its parent, the new spans named, and a steady proof's
copies, reads and syncs as the chain's sizes give them; ``launches`` is
the kernel wrappers' own count.  With tracing off a proof leaves no
record.  Under the benchmark's tracer the ``za.`` ranges are host
ranges.  On a card (``cuda``), torch's sync debug mode counts the same
syncs as one proof's record."""

import importlib
import logging
import os
import re
import warnings

import pytest
import torch

import za_tpu_torch.engine.engine as engine_mod
import za_tpu_torch.engine.msm_dense as msm_dense
from za_tpu_torch.engine import _build, metrics

prove_mod = importlib.import_module("za_tpu_torch.groth16.prove")

NEW_SPANS = {"prove", "witness.convert", "witness.h2d", "msm.g1.readback",
             "msm.g2.readback", "combine", "domain.tables"}
# a readback reads X, Y, Z of each point, 8 32-bit limbs a coordinate;
# a G2 coordinate has two components
COORD_BYTES = 8 * 4
PROOF_LINE = re.compile(r"^\[proof\] id=(\d+) wall=[0-9.]+s syncs=(\d+) "
                        r"h2d=([0-9.]+)MB d2h=([0-9.]+)MB launches=(\d+) "
                        r"witness_native=(\d+) witness_fallback=(\d+)$")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The chain's pk (raw queries, as the staged engine reads them), its
    R1CS and witness."""
    import torch_chain_pk as CHAIN
    from test_torch_metrics import _chain_r1cs
    from za_tpu_torch.groth16 import format as fmt

    built = CHAIN.build(str(tmp_path_factory.mktemp("chain")))
    with open(os.path.join(built["dir"], "proving.key"), "rb") as f:
        pk = fmt.read_pk(f, raw_queries=True)
    r1cs, z = _chain_r1cs(pk)
    return {"params": pk.params, "r1cs": r1cs, "z": z,
            "gate": CHAIN.STAGED_GATE}


@pytest.fixture
def prover(chain, monkeypatch):
    """-> prove_n(k, route): k proofs of the chain by one fresh CPU engine
    (a new witness list each), the records they left."""
    monkeypatch.setattr(prove_mod, "STAGED_MIN", chain["gate"])
    monkeypatch.setattr(msm_dense, "CPU_SLOTS", {False: 16, True: 16})

    def prove_n(k, route):
        if route == "tree":
            monkeypatch.setattr(engine_mod, "TREE_MIN", 0)
        eng = engine_mod.GpuEngine(device="cpu")
        last = max((r["id"] for r in metrics.recent()), default=0)
        for _ in range(k):
            prove_mod.prove(chain["params"], chain["r1cs"], list(chain["z"]),
                            r=13, s=17, engine=eng)
        return [r for r in metrics.recent() if r["id"] > last]
    return prove_n


def _steady_counts(chain, route) -> dict:
    """What a proof after the first moves: the witness uploaded once as
    (nv, 8) int32 rows, a copy the host does not wait for, every value
    converted natively; read back, h's top coefficient's flag and each
    MSM call's X, Y, Z (tree: a, b1, l in one call, h in another; dense:
    all four G1 in one), one sync a read."""
    nv = chain["r1cs"].num_vars
    g1_calls = [3, 1] if route == "tree" else [4]
    d2h = 1 + sum(3 * COORD_BYTES * m for m in g1_calls) + 6 * COORD_BYTES
    return {"h2d_copies": 1, "h2d_bytes": 8 * 4 * nv, "d2h_bytes": d2h,
            "syncs": 1 + 3 * len(g1_calls) + 6, "syncs_timer": 0,
            "witness_native": nv, "witness_fallback": 0}


@pytest.mark.parametrize("route", ["dense", "tree"])
def test_each_proof_records_a_tree_of_spans(chain, prover, monkeypatch,
                                            caplog, route):
    monkeypatch.setattr(metrics.StageTimer, "enabled", True)
    with caplog.at_level(logging.INFO, logger="za_tpu_torch.metrics"):
        recs = prover(2, route)
    assert len(recs) == 2
    assert recs[1]["id"] == recs[0]["id"] + 1
    for rec in recs:
        assert rec["error"] is None and not rec["profiled"]
        spans = rec["spans"]
        roots = [s for s in spans if s["parent"] is None]
        assert [s["name"] for s in roots] == ["prove"] and spans[0] is roots[0]
        for i, s in enumerate(spans):
            assert s["start_ns"] <= s["end_ns"], s
            if s["parent"] is not None:
                assert s["parent"] < i
                p = spans[s["parent"]]
                assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                    <= p["end_ns"], (p, s)
        parent = {s["name"]: spans[s["parent"]]["name"] for s in spans
                  if s["parent"] is not None}
        assert parent["witness.convert"] == "h.z_to_limbs"
        assert parent["witness.h2d"] == "h.z_to_limbs"
        assert parent["combine"] == "prove"
    first, steady = ({s["name"] for s in r["spans"]} for r in recs)
    assert NEW_SPANS <= first
    assert NEW_SPANS - {"domain.tables"} <= steady
    assert "domain.tables" not in steady     # built by the first prove only
    counts = recs[1]["counters"]
    assert {k: counts[k] for k in _steady_counts(chain, route)} \
        == _steady_counts(chain, route)
    lines = [PROOF_LINE.match(r.getMessage()) for r in caplog.records
             if r.getMessage().startswith("[proof]")]
    assert all(lines) and len(lines) == 2
    last = lines[-1].groups()
    assert int(last[0]) == recs[1]["id"]
    assert int(last[1]) == counts["syncs"]
    assert float(last[2]) == pytest.approx(counts["h2d_bytes"] / 1e6,
                                           abs=1e-6)
    assert (int(last[5]), int(last[6])) == (counts["witness_native"],
                                            counts["witness_fallback"])


def test_launches_are_the_kernel_wrappers_deltas(prover, monkeypatch):
    """The CPU runs every wrapper's plain version, which launches
    nothing; a matvec and a tree MSM that count launches as their
    wrappers do show in the record as the wrappers' deltas."""
    monkeypatch.setattr(metrics.StageTimer, "enabled", True)
    mv, tree = _build.KERNELS["r1cs_matvec_fr"], _build.KERNELS[
        "tree_level_g1"]
    real_mv, real_tree = engine_mod.RC.matvec, engine_mod.CT.msm_tree

    def matvec(*a):
        mv.launches += 1
        return real_mv(*a)

    def msm_tree(*a):
        tree.launches += 3
        return real_tree(*a)

    monkeypatch.setattr(engine_mod.RC, "matvec", matvec)
    monkeypatch.setattr(engine_mod.CT, "msm_tree", msm_tree)
    before = {k: v.launches for k, v in _build.KERNELS.items()}
    rec, = prover(1, "tree")
    deltas = {k: v.launches - before[k] for k, v in _build.KERNELS.items()}
    assert {k: d for k, d in deltas.items() if d} == {
        "r1cs_matvec_fr": 1, "tree_level_g1": 9}
    assert rec["counters"]["launches"] == sum(deltas.values()) == 10


def test_tracing_off_adds_no_record(prover, monkeypatch, caplog):
    monkeypatch.setattr(metrics.StageTimer, "enabled", False)
    before = metrics.recent()
    with caplog.at_level(logging.INFO, logger="za_tpu_torch"):
        assert prover(1, "dense") == []
    after = metrics.recent()
    assert len(after) == len(before) and all(
        a is b for a, b in zip(after, before))
    assert "[proof]" not in caplog.text and "[stage]" not in caplog.text


def test_za_ranges_are_host_ranges_under_the_bench_tracer(prover,
                                                         monkeypatch, caplog):
    """With the timer off, a recording profiler (prover_bench's tracer)
    turns the record on, marks it profiled, and sees each span as a host
    range ``za.<name>``, none on the device's side; no line is logged."""
    from prover_bench.trace import traced

    monkeypatch.setattr(metrics.StageTimer, "enabled", False)
    with caplog.at_level(logging.INFO, logger="za_tpu_torch"), \
            traced("cpu") as box:
        rec, = prover(1, "dense")
    assert "[proof]" not in caplog.text and "[stage]" not in caplog.text
    assert NEW_SPANS <= {s["name"] for s in rec["spans"]}
    assert rec["counters"]["h2d_copies"] > 0
    tr = box["trace"]
    host = {n for n, _, _ in tr.host if n.startswith("za.")}
    assert {"za." + s["name"] for s in rec["spans"]} == host
    assert {"za.prove", "za.combine", "za.witness.convert",
            "za.msm.g1.readback", "za.h.z_to_limbs"} <= host
    assert not [n for n, _, _ in tr.device if n.startswith("za.")]
    assert rec["profiled"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dense", "tree"])
def test_sync_debug_mode_counts_the_records_syncs(monkeypatch, route):
    """On the card, timer off (a CPU-only profiler turns the record on):
    the warnings of torch's sync debug mode over one steady proof are
    the record's syncs.  Inputs from prover_bench's chain (no JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from prover_bench import inputs, program
    from prover_bench.circuits import chain

    circuit = chain.rows({"constraints": 1 << 10})
    wit = [chain.witness({"constraints": 1 << 10}, inputs.stream(7, "w"))]
    pk = inputs.proving_key(circuit, inputs.proving_key_logs(7))
    prm, rc = program.params(pk), program.r1cs(circuit)
    if route == "tree":
        monkeypatch.setattr(engine_mod, "TREE_MIN", 0)
    monkeypatch.setattr(metrics.StageTimer, "enabled", False)
    eng = engine_mod.GpuEngine()
    eng.stage_params(prm, rc)
    program.prove_once(prm, rc, list(wit[0]), 5, 7, eng)     # warm
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                program.prove_once(prm, rc, list(wit[0]), 11, 13, eng)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in got if "synchroniz" in str(w.message)]
    rec = metrics.recent()[-1]
    assert rec["counters"]["syncs"] == len(syncs) > 0
    assert rec["counters"]["syncs_timer"] == 0
    assert rec["counters"]["h2d_copies"] == 1     # the witness alone
