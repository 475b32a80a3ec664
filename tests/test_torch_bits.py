"""circomlib's ``Num2Bits(n)`` range check through the port, as the
benchmark's ``bits`` generator (``prover_bench/circuits/bits.py``) builds
it: its rows hold for its witness; they are, in order, what the port's
frontend emits for the template written in za's dialect; the port's
prove on the CPU engine gives the exact proof on a real key (host, dense
and tree routes) and the benchmark reference's proof on its pool key; the
``witness_digits`` counter and its reader ``msm_live_digit_pct`` count the
nonzero 4-bit digits of the uploaded values, natively and in Python.
The matvec kernel on the generator's rows is ``test_torch_cuda.py``'s."""

import importlib
import random
from pathlib import Path

import pytest
import torch

from za_tpu.groth16.r1cs import R1CS as ZR1CS
from za_tpu.groth16.setup import (
    generate_parameters as z_generate_parameters,
)
from za_tpu.groth16.verify import verify_proof as z_verify_proof
from za_tpu.groth16.prove import Proof as ZProof
from za_tpu.curve import Fq2 as ZFq2
import za_tpu_torch.engine.engine as engine_mod
import za_tpu_torch.engine.msm_dense as msm_dense
from za_tpu_torch.compiler import Evaluator, Mode, optimize
from za_tpu_torch.curve import R
from za_tpu_torch.engine import field as F, metrics
from za_tpu_torch.groth16 import HostEngine, prove, verify_proof
from za_tpu_torch.groth16.convert import params_from_arrays
from za_tpu_torch.groth16.r1cs import R1CS

from prover_bench import inputs, program, run
from prover_bench.circuits import bits
from prover_bench.reference.groth16 import Expected, judge
from test_torch_prove import TOXIC, _FixedBase, _expected_proof, \
    params_to_arrays

prove_mod = importlib.import_module("za_tpu_torch.groth16.prove")
ROOT = Path(__file__).resolve().parents[1]

#: circomlib's template (circuits/bitify.circom) in za's dialect, under a
#: main with one public input for instance 0 and private ones for the rest
NUM2BITS = """
template Num2Bits(n) {
    signal input in;
    signal output out[n];
    var lc1 = 0;
    var e2 = 1;
    for (var i = 0; i < n; i = i + 1) {
        #[w] out[i] <-- (in >> i) & 1;
        out[i] * (out[i] - 1) === 0;
        lc1 = lc1 + out[i] * e2;
        e2 = e2 + e2;
    }
    lc1 === in;
}

template Main(n, K) {
    signal input x;
    signal private input in[K - 1];
    component n2b[K];
    for (var k = 0; k < K; k = k + 1) {
        n2b[k] = Num2Bits(n);
    }
    n2b[0].in <== x;
    for (var k = 1; k < K; k = k + 1) {
        n2b[k].in <== in[k - 1];
    }
}

component main = Main(%d, %d);
"""


def _config(n, K):
    return {"bits": n, "instances": K, "constraints": K * (n + 1)}


def _dot(row, z):
    return sum(c * z[v] for v, c in row) % R


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,K", [(8, 3), (254, 2)])
def test_generator_rows_hold_for_its_witness(n, K):
    cfg = _config(n, K)
    circ = bits.rows(cfg)
    z = bits.witness(cfg, random.Random(n * 31 + K))
    nv = circ["num_inputs"] + circ["num_aux"]
    assert (circ["num_inputs"], nv, len(z)) == (2, 1 + K + n * K, nv)
    assert len(circ["a"]) == len(circ["b"]) == len(circ["c"]) \
        == cfg["constraints"]
    for a, b, c in zip(circ["a"], circ["b"], circ["c"]):
        assert _dot(a, z) * _dot(b, z) % R == _dot(c, z)
    assert set(z[K + 1:]) <= {0, 1} and z[0] == 1
    assert any(v > 1 for v in z[1:K + 1])
    # a wrong bit breaks its instance's linear row
    z[K + 1] ^= 1
    assert any(_dot(a, z) * _dot(b, z) % R != _dot(c, z)
               for a, b, c in zip(circ["a"], circ["b"], circ["c"]))
    with pytest.raises(ValueError):
        bits.rows(dict(cfg, constraints=cfg["constraints"] + 1))


@pytest.mark.parametrize("n,K", [(8, 3), (3, 2)])
def test_the_frontend_emits_the_generator_rows(tmp_path, n, K):
    (tmp_path / "bits.za").write_text(NUM2BITS % (n, K))
    ev = Evaluator(Mode.GEN_CONSTRAINTS)
    ev.eval_file(str(tmp_path), "bits.za")
    assert len(ev.constraints) == K * (n + 2)      # with the wiring rows
    constraints, removed = optimize(ev.constraints,
                                    ev.signals.main_input_ids())
    r1cs = R1CS.from_constraints(ev.signals, constraints, removed)
    want = bits.rows(_config(n, K))
    assert (r1cs.num_inputs, r1cs.num_aux, r1cs.input_names) == (
        want["num_inputs"], want["num_aux"], want["input_names"])
    assert (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows) == (
        want["a"], want["b"], want["c"])


# -- proofs at (n, K) = (254, 2): 510 rows, 511 variables, domain 512 -----------

N, K = 254, 2


@pytest.fixture(scope="module")
def bits510():
    cfg = _config(N, K)
    circ = bits.rows(cfg)
    z = bits.witness(cfg, random.Random(11))
    zr1cs = ZR1CS(num_inputs=circ["num_inputs"], num_aux=circ["num_aux"],
                  input_names=circ["input_names"], a_rows=circ["a"],
                  b_rows=circ["b"], c_rows=circ["c"], var_of_signal=[])
    zparams = z_generate_parameters(zr1cs, **TOXIC, engine=_FixedBase())
    params = params_from_arrays(params_to_arrays(zparams))
    return cfg, circ, z, zr1cs, zparams, params


@pytest.fixture
def staged_gate(monkeypatch):
    """The staged branch at the circuit's 511 variables and domain
    points (its gate is 512), dense slots cut for the CPU."""
    monkeypatch.setattr(prove_mod, "STAGED_MIN", 1 + K + N * K)
    monkeypatch.setattr(msm_dense, "CPU_SLOTS", {False: 16, True: 16})
    return monkeypatch


@pytest.mark.parametrize("route", ["host", "dense", "tree"])
def test_prove_equals_the_exact_proof_and_verifies(bits510, staged_gate,
                                                   route):
    _, circ, z, zr1cs, zparams, params = bits510
    r1cs = program.r1cs(circ)
    if route == "host":
        eng = HostEngine()
    else:
        if route == "tree":
            staged_gate.setattr(engine_mod, "TREE_MIN", 0)
        eng = engine_mod.GpuEngine(device="cpu")
    proof = prove(params, r1cs, list(z), r=13, s=17, engine=eng)
    if route != "host":
        staged = params._staged_cache[1]
        assert ("g1abl" in staged) == (route == "tree")
        assert ("g1x4" in staged) == (route == "dense")
    zb = (ZFq2(proof.b[0].c0, proof.b[0].c1),
          ZFq2(proof.b[1].c0, proof.b[1].c1))
    assert (proof.a, zb, proof.c) == _expected_proof(
        zr1cs, z, params.domain_size, 13, 17)
    assert z_verify_proof(zparams.vk, ZProof(a=proof.a, b=zb, c=proof.c),
                          z[1:2])
    assert verify_proof(params.vk, proof, z[1:2])
    assert not verify_proof(params.vk, proof, [(z[1] + 1) % R])


@pytest.mark.parametrize("pools", [None, (1, 1)], ids=["benchmark", "one"])
def test_pool_key_proof_equals_the_benchmark_reference(bits510, staged_gate,
                                                       pools):
    """The cell's path at this size: the pool pk staged on the tree
    route, the proof against ``prover_bench.reference``; the proof's
    record gives ``msm_live_digit_pct`` its share.  With one point a
    query (``one``) the tree's sums of bits meet P + P and P + (-P) at
    every level, as the benchmark's 19 G2 points do at 2^20."""
    cfg, circ, z, *_ = bits510
    staged_gate.setattr(engine_mod, "TREE_MIN", 0)
    staged_gate.setattr(metrics.StageTimer, "enabled", True)
    if pools is not None:
        staged_gate.setattr(inputs, "G1_POOL", pools[0])
        staged_gate.setattr(inputs, "G2_POOL", pools[1])
    logs = inputs.proving_key_logs(2**31 + 11)
    prm = program.params(inputs.proving_key(circ, logs))
    rc, eng = program.r1cs(circ), program.GpuEngine(device="cpu")
    proof = program.prove_once(prm, rc, list(z), 13, 17, eng)
    assert "g1abl" in prm._staged_cache[1]
    assert judge(Expected(circ, logs), [z],
                 [(0, 13, 17, program.plain(proof))]) \
        == {"A": 0, "B": 0, "C": 0}
    live = sum(1 for v in z for k in range(64) if (v >> 4 * k) & 15)
    c = metrics.recent()[-1]["counters"]
    assert c["witness_digits"] == live
    got = _reader("msm_live_digit_pct").read({"proofs": [{}]})
    assert got == pytest.approx(100 * live / (64 * len(z)))
    assert 1 < got < 2


# -- the counter and its reader ------------------------------------------------------


def _reader(name):
    """The metric's reader, found by name through the cell that lists it."""
    cell = run.Cell(ROOT, "bits-1m.closed")
    assert name in {m["name"] for m in cell.metrics("per_layer")}
    return cell.reader(name)


MIXED = [0, 1, 0, 1, 1, 2, 15, 16, 0x10F, 2**64 - 1, 2**200 + 1, R - 1, R,
         R + 17, 2**256 - 1, -1, -R, True, 2**300 + 5, 7, 0]


def _live_digits(vs):
    return sum(1 for v in vs for k in range(64) if (int(v % R) >> 4 * k) & 15)


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_witness_digits_counts_nonzero_digits_of_z_mod_r(monkeypatch, native):
    monkeypatch.setattr(metrics.StageTimer, "enabled", True)
    if not native:
        monkeypatch.setattr(engine_mod, "witness_lib", lambda: None)
    rng = random.Random(5)
    z = MIXED + [rng.randrange(R) for _ in range(200)] \
        + [rng.randrange(1 << 20) for _ in range(100)]
    want = _live_digits(z)
    eng = engine_mod.GpuEngine(device="cpu")
    with metrics.ProofSpan():
        eng.witness_limbs_dev(z)
    c = metrics.recent()[-1]["counters"]
    assert c["witness_digits"] == want
    assert c["witness_native"] + c["witness_fallback"] == len(z)
    if native:
        rows = torch.empty((len(z), F.NL32), dtype=torch.int32)
        assert F.witness_rows(z, rows, True) == (c["witness_fallback"], want)
        assert F.witness_rows(z, rows) == (c["witness_fallback"], None)
        assert c["witness_fallback"] == 4     # -1, -R, True, 2^300 + 5
    assert F.limb_digits(F.ints_to_limbs([v % R for v in z])) == want


def _rec(i, native=None, fallback=0, digits=None):
    counters = {}
    if native is not None:
        counters.update(witness_native=native, witness_fallback=fallback)
    if digits is not None:
        counters["witness_digits"] = digits
    return {"id": i, "profiled": False, "error": None, "spans": [],
            "counters": counters}


@pytest.mark.parametrize("recs, want", [
    ([], None),
    ([_rec(1, 4), _rec(2, 4)], None),                   # no digit counter
    ([_rec(1, 0, 0, 0)], None),                         # nothing uploaded
    ([_rec(1, 10, 0, 640)], 100.0),
    ([_rec(1, 3, 1, 64), _rec(2, 4, 0, 128), _rec(3, 2, 2, 32)], 25.0),
], ids=["no_records", "no_counter", "no_values", "all_live", "median"])
def test_msm_live_digit_pct_reads_the_counter(monkeypatch, recs, want):
    monkeypatch.setattr(metrics, "recent", lambda: list(recs))
    got = _reader("msm_live_digit_pct").read({"proofs": [{}] * len(recs)})
    assert got == (None if want is None else pytest.approx(want))
