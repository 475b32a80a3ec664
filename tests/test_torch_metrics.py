"""The engine's per-stage metrics (za_tpu_torch/engine/metrics.py) on the
CPU: with the timer on, a GpuEngine(device="cpu") proof from the
30-constraint chain's pk (tests/torch_chain_pk.py, the staged gate
lowered to its size) logs a line for every step of its route, dense and
tree, under the names of the reference's _StageTimer where a step has a
counterpart; with the timer off it logs none; the proof is za_tpu's
proof.json either way.  On a CUDA device the timer records an event
pair (a stand-in Event class here); off it creates none.  ``za -v``
turns the timer on through ZA_METRICS unless the variable is set."""

import importlib
import logging
import os
import re
import shutil

import pytest
import torch

import za_tpu_torch.engine.engine as engine_mod
import za_tpu_torch.engine.msm_dense as msm_dense
from za_tpu_torch import cli
from za_tpu_torch.curve import G1_GEN, g1_mul
from za_tpu_torch.engine import metrics
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16 import helper

import torch_chain_pk as CHAIN
from test_torch_prove import _one_thread  # noqa: F401 -- autouse fixture

prove_mod = importlib.import_module("za_tpu_torch.groth16.prove")

# every name a helper.prove logs on each route (brackets cut): the
# constraint check's legs serve h(x), so h.csr and h.matvec do not run
COMMON = {"stage.expand_queries", "sat.csr", "sat.matvec", "sat.check",
          "h.z_to_limbs", "h.ntt.intt", "h.ntt.coset", "h.combine+intt",
          "h.to_scalars", "msm.g1.scalars", "msm.g2.scalars"}
ROUTE_NAMES = {
    "dense": COMMON | {"stage.g1x4", "stage.b_g2", "msm.g1.kernel",
                       "msm.g2.kernel"},
    "tree": COMMON | {"stage.gpucache.load", "stage.tree.g1abl",
                      "stage.tree.g1h", "stage.tree.b_g2",
                      "stage.gpucache.save", "stage.blocks.g1",
                      "stage.blocks.g2", "msm.g1.tree", "msm.g2.tree"},
}
LINE = re.compile(r"^\[stage\] ([^:\[]+)(\[[^\]]*\])?: (.*)$")


@pytest.fixture(autouse=True)
def _staged_gate(monkeypatch):
    for mod in (prove_mod, helper):
        monkeypatch.setattr(mod, "STAGED_MIN", CHAIN.STAGED_GATE)
    monkeypatch.setattr(msm_dense, "CPU_SLOTS", {False: 16, True: 16})


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    return CHAIN.build(str(tmp_path_factory.mktemp("chain")))


def _stage_lines(caplog) -> list:
    """-> [(name without brackets, bracket, rest)] of the [stage] lines."""
    out = []
    for rec in caplog.records:
        m = LINE.match(rec.getMessage())
        if m:
            assert rec.name == "za_tpu_torch.metrics"
            out.append(m.groups())
    return out


def _prove(chain, tmp_path, timer_on: bool, monkeypatch, caplog):
    pk = tmp_path / "proving.key"
    if not pk.exists():
        shutil.copy(os.path.join(chain["dir"], "proving.key"), pk)
    monkeypatch.setattr(metrics.StageTimer, "enabled", timer_on)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="za_tpu_torch"):
        proof = helper.prove(str(pk), CHAIN.port_inputs(),
                             engine=GpuEngine(device="cpu"),
                             deterministic_rs=CHAIN.RS)
    return proof, _stage_lines(caplog)


@pytest.mark.parametrize("route", ["dense", "tree"])
def test_proof_logs_every_stage_of_its_route(chain, tmp_path, monkeypatch,
                                              caplog, route):
    if route == "tree":
        monkeypatch.setattr(engine_mod, "TREE_MIN", 0)
    else:  # timer off: no line, the same proof
        proof, lines = _prove(chain, tmp_path, False, monkeypatch, caplog)
        assert proof == chain["proof_json"]
        assert lines == [] and "[stage]" not in caplog.text
    proof, lines = _prove(chain, tmp_path, True, monkeypatch, caplog)
    assert proof == chain["proof_json"]
    assert {name for name, _, _ in lines} == ROUTE_NAMES[route]
    for name, bracket, rest in lines:
        if name.startswith("stage.blocks."):
            parts = [p.split()[0] for p in rest.split(", ")]
            assert parts == ["coords", "upload", "mont", "on_curve",
                             "tables"], rest
        else:
            assert re.fullmatch(r"[0-9.]+s", rest), rest   # no device
    brackets = {name: b for name, b, _ in lines if b}
    if route == "tree":
        assert brackets["msm.g1.tree"] in ("[C=1,S=32,M=3]", "[C=1,S=32,M=1]")
        assert brackets["stage.blocks.g2"] == "[M=1,blocks=1]"
    else:
        assert brackets["msm.g1.kernel"] == "[n=32,M=4]"


def test_h_and_host_points_name_their_steps(chain, monkeypatch, caplog):
    """h(x) without the constraint check's legs times its own CSR and
    matvec; an MSM over host points times their staging."""
    from za_tpu_torch.groth16 import format as fmt
    from za_tpu_torch.groth16.domain import Domain

    with open(os.path.join(chain["dir"], "proving.key"), "rb") as f:
        pk = fmt.read_pk(f)
    monkeypatch.setattr(metrics.StageTimer, "enabled", True)
    eng = GpuEngine(device="cpu")
    r1cs, z = _chain_r1cs(pk)
    with caplog.at_level(logging.INFO, logger="za_tpu_torch.metrics"):
        eng.h_coeffs_limbs(r1cs, z, Domain(pk.params.domain_size))
        pts = [g1_mul(G1_GEN, k) for k in (2, 3, 5)]
        assert eng.msm_g1(pts, [7, 11, 13]) == g1_mul(
            G1_GEN, 2 * 7 + 3 * 11 + 5 * 13)
    names = [name for name, _, _ in _stage_lines(caplog)]
    assert names == ["h.z_to_limbs", "h.csr", "h.matvec", "h.ntt.intt",
                     "h.ntt.coset", "h.combine+intt", "h.to_scalars",
                     "msm.g1.stage", "h.z_to_limbs", "msm.g1.scalars",
                     "msm.g1.kernel"]


def _chain_r1cs(pk):
    """The chain's R1CS and witness, interpreted from the pk's ASTs."""
    from za_tpu_torch.algebra import Value
    from za_tpu_torch.compiler import Evaluator, Mode
    from za_tpu_torch.groth16.r1cs import R1CS

    ev = Evaluator(Mode.GEN_WITNESS)
    for name, v in CHAIN.port_inputs():
        ev.set_deferred_value(name, Value(v))
    ev.eval_asts(pk.asts)
    r1cs = R1CS.from_constraints(ev.signals, pk.constraints,
                                 pk.ignore_signals)
    return r1cs, r1cs.assignment_from_signals(ev.signals)


class _FakeEvent:
    """torch.cuda.Event's timing surface; elapsed 2 ms a pair."""
    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = self.synced = False
        _FakeEvent.made.append(self)

    def record(self):
        self.recorded = True

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert self.recorded and end.recorded
        return 2.0


class _FakeStream:
    def synchronize(self):
        _FakeEvent.made.append("stream sync")


@pytest.mark.parametrize("on", [False, True])
def test_cuda_stage_records_events_only_when_on(monkeypatch, caplog, on):
    monkeypatch.setattr(metrics.StageTimer, "enabled", on)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream())
    monkeypatch.setattr(_FakeEvent, "made", [])
    with caplog.at_level(logging.INFO, logger="za_tpu_torch.metrics"):
        with metrics.StageTimer("msm.g1.scalars", "cuda"):
            pass
        with metrics.StageParts("stage.blocks.g1[M=1,blocks=2]",
                                "cuda") as parts:
            for _ in range(2):
                with parts.part("upload"):
                    pass
    lines = [r.getMessage() for r in caplog.records]
    if not on:
        assert _FakeEvent.made == [] and lines == []
        return
    # a pair for the stage, synced once; a pair a block for the part,
    # the stream synced once at the line
    events = [e for e in _FakeEvent.made if e != "stream sync"]
    assert len(events) == 6 and _FakeEvent.made.count("stream sync") == 1
    assert [e.synced for e in events[:2]] == [False, True]
    assert re.fullmatch(r"\[stage\] msm\.g1\.scalars: [0-9.]+s device "
                        r"0\.002000s", lines[0]), lines[0]
    assert re.fullmatch(r"\[stage\] stage\.blocks\.g1\[M=1,blocks=2\]: "
                        r"upload [0-9.]+s device 0\.004000s", lines[1])


def test_cli_verbose_turns_the_timer_on(tmp_path, monkeypatch):
    """-v sets ZA_METRICS=1 unless it is set; without -v it stays
    unset.  (The variable is read when the engine is imported, which the
    CLI does after this, in _engine.)"""
    (tmp_path / "circuit.za").write_text(
        "template T() { signal input a; signal input b; a === b; }\n"
        "component main = T();\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ZA_METRICS", "x")      # restored after the test
    monkeypatch.delenv("ZA_METRICS")
    assert cli.main(["compile"]) == 0
    assert "ZA_METRICS" not in os.environ
    assert cli.main(["-v", "compile"]) == 0
    assert os.environ["ZA_METRICS"] == "1"
    os.environ["ZA_METRICS"] = "0"
    assert cli.main(["-v", "compile"]) == 0
    assert os.environ["ZA_METRICS"] == "0"
