"""The benchmark's inputs and its plain reference, at tiny sizes on the
CPU: the generator's witness satisfies its rows, the pool pk's points
lie on the curve, and the reference's proof equals the port's
HostEngine proof of the same inputs, r and s."""

import importlib
import os
import sys

import pytest

from prover_bench import inputs
from prover_bench.circuits import chain
from prover_bench.reference import bn254
from prover_bench.reference.groth16 import Expected, control_proofs, judge

R = bn254.R
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _lc(row, z):
    return sum(c * z[v] for v, c in row) % R


@pytest.mark.parametrize("n", [1, 30, 257])
def test_chain_witness_satisfies_its_rows(n):
    cfg = {"constraints": n}
    c = chain.rows(cfg)
    z = chain.witness(cfg, inputs.stream(7, "witness"))
    assert len(z) == c["num_inputs"] + c["num_aux"]
    for a, b, cc in zip(c["a"], c["b"], c["c"]):
        assert _lc(a, z) * _lc(b, z) % R == _lc(cc, z)
    z[5 if n > 3 else 2] += 1
    assert any(_lc(a, z) * _lc(b, z) % R != _lc(cc, z)
               for a, b, cc in zip(c["a"], c["b"], c["c"]))


def test_same_seed_same_inputs():
    cfg = {"constraints": 30}
    assert (inputs.witness_pool(chain, cfg, 2**31 + 11, 3)
            == inputs.witness_pool(chain, cfg, 2**31 + 11, 3))
    assert inputs.proving_key_logs(5) == inputs.proving_key_logs(5)
    assert inputs.proving_key_logs(5) != inputs.proving_key_logs(6)


def test_pool_pk_points_lie_on_the_curve():
    c = chain.rows({"constraints": 30})
    logs = inputs.proving_key_logs(3)
    pk = inputs.proving_key(c, logs)
    assert pow(logs["tau"], inputs.H_POOL, R) == 1 and logs["tau"] != 1

    def ints(a):
        return [sum(int(a[k, j]) << (16 * k) for k in range(16))
                for j in range(a.shape[1])]

    for q in ("a", "b1", "l", "h"):
        xs, ys = ints(pk[q]["x"]), ints(pk[q]["y"])
        assert all(bn254.on_curve(p, bn254.Fq) for p in zip(xs, ys))
    x0, x1, y0, y1 = (ints(pk["b2"][k]) for k in ("x0", "x1", "y0", "y1"))
    assert all(bn254.on_curve(((a, b), (c_, d)), bn254.Fq2)
               for a, b, c_, d in zip(x0, x1, y0, y1))
    # the h query's point i has the log k tau^i
    g1 = bn254.FixedBase(bn254.G1, bn254.Fq)
    for i in (0, 1, 30):
        assert (ints(pk["h"]["x"])[i]
                == g1.mul(logs["k"] * pow(logs["tau"], i, R))[0])


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_reference_proof_equals_the_ports_host_engine(seed):
    from prover_bench import program

    prove_mod = importlib.import_module("za_tpu_torch.groth16.prove")
    cfg = {"constraints": 30}
    c = chain.rows(cfg)
    z = chain.witness(cfg, inputs.stream(seed, "witness"))
    logs = inputs.proving_key_logs(seed)
    pk = inputs.proving_key(c, logs)
    r, s = inputs.Randomness(seed).next()
    proof = prove_mod.prove(program.params(pk), program.r1cs(c), list(z),
                            r=r, s=s, engine=prove_mod.HostEngine())
    got = program.plain(proof)
    exp = Expected(c, logs)
    assert got == exp.points(exp.terms(z), r, s)
    assert judge(exp, [z], [(0, r, s, got)]) == {"A": 0, "B": 0, "C": 0}
    bad = (got[0], got[1], bn254.affine(bn254.add(
        bn254.jac(got[2], bn254.Fq), bn254.jac(bn254.G1, bn254.Fq),
        bn254.Fq), bn254.Fq))
    assert judge(exp, [z], [(0, r, s, bad)]) == {"A": 0, "B": 0, "C": 1}


def test_control_fails_the_comparison():
    """The control (the reference with each witness value cut to 253
    bits in the witness MSMs) in the prover's place reads wrong."""
    cfg = {"constraints": 30}
    c = chain.rows(cfg)
    ws = inputs.witness_pool(chain, cfg, 9, 2)
    exp = Expected(c, inputs.proving_key_logs(9))
    rs = inputs.Randomness(9)
    draws = [(k % 2, *rs.next()) for k in range(4)]
    ctl = control_proofs(exp, ws, draws, (1 << 253) - 1)
    wrong = judge(exp, ws, ctl)
    assert wrong["A"] == 4 and wrong["B"] == 4 and wrong["C"] == 4


def test_reference_imports_nothing_of_the_program():
    import subprocess

    code = ("import sys; import prover_bench.reference.groth16, "
            "prover_bench.inputs; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('za_tpu', 'za_tpu_torch', 'jax', 'torch')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True)
    assert out.stdout.strip() == "[]"
