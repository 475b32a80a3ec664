"""The whole slice on the CPU: za_tpu's trusted setup carried across
with groth16.convert, then the port's prove through GpuEngine(device=
"cpu") (every kernel wrapper on its plain version) on a 510-constraint
chain, the size where the staged branch starts.  The proof must equal
the one za_tpu's prover makes with the same r, s (computed here in
closed form from the known toxic waste) and za_tpu's verifier must
accept it."""

import random

import numpy as np
import pytest
import torch

import za_tpu.engine.field as ZF
from za_tpu.curve import (
    G1_GEN as ZG1, G2_GEN as ZG2, Fq2 as ZFq2, R, g1_add as z_g1_add,
    g1_mul as z_g1_mul, g2_add as z_g2_add, g2_mul as z_g2_mul,
)
from za_tpu.groth16.domain import Domain as ZDomain
from za_tpu.groth16.prove import Proof as ZProof
from za_tpu.groth16.r1cs import R1CS as ZR1CS
from za_tpu.groth16.setup import (
    generate_parameters as z_generate_parameters, qap_evals_at_tau,
)
from za_tpu.groth16.verify import verify_proof as z_verify_proof
import za_tpu_torch.engine.engine as engine_mod
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16 import (
    HostEngine, generate_parameters, prove, verify_proof,
)
from za_tpu_torch.groth16.convert import params_from_arrays, r1cs_from_arrays

TOXIC = dict(tau=11, alpha=3, beta=5, gamma=7, delta=9)


def _chain_rows(n, seed=99):
    rng = random.Random(seed)
    a, b, c = [], [], []
    z = [1, rng.randrange(1, R)]
    for i in range(n):
        a.append([(i + 1, 1)])
        b.append([(i + 1, 1)])
        c.append([(i + 2, 1), (0, (-i) % R)])
        z.append((z[i + 1] * z[i + 1] + i) % R)
    return a, b, c, z


def _csr(rows):
    ptr, cols, coeffs = [0], [], []
    for row in rows:
        for var, coeff in row:
            cols.append(var)
            coeffs.append(coeff)
        ptr.append(len(cols))
    return {"indptr": np.array(ptr), "indices": np.array(cols),
            "coeffs": ZF.ints_to_limbs(coeffs).astype(np.uint16)}


def _g1_arrays(points):
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return {k: ZF.ints_to_limbs(v) for k, v in zip("xyz", (xs, ys, zs))}


def _g2_arrays(points):
    get = {
        "x0": lambda p: p[0].c0, "x1": lambda p: p[0].c1,
        "y0": lambda p: p[1].c0, "y1": lambda p: p[1].c1,
    }
    out = {k: ZF.ints_to_limbs([0 if p is None else f(p) for p in points])
           for k, f in get.items()}
    out["y0"][0, [i for i, p in enumerate(points) if p is None]] = 1
    out["z0"] = ZF.ints_to_limbs([0 if p is None else 1 for p in points])
    return out


def _g2_ints(p):
    return None if p is None else ((p[0].c0, p[0].c1), (p[1].c0, p[1].c1))


def params_to_arrays(params):
    """za_tpu Groth16Parameters -> the raw array layout of convert.py."""
    vk = params.vk
    return {
        "vk": {
            "alpha_g1": vk.alpha_g1, "beta_g1": vk.beta_g1,
            "beta_g2": _g2_ints(vk.beta_g2),
            "gamma_g2": _g2_ints(vk.gamma_g2),
            "delta_g1": vk.delta_g1, "delta_g2": _g2_ints(vk.delta_g2),
            "ic": list(vk.ic),
        },
        "a": _g1_arrays(params.a), "b_g1": _g1_arrays(params.b_g1),
        "l": _g1_arrays(params.l), "h": _g1_arrays(params.h),
        "b_g2": _g2_arrays(params.b_g2),
        "domain_size": params.domain_size,
    }


class _FixedBase:
    """Host fixed-base scalar multiplication for za_tpu's setup, from
    tables k * 16^j * G (k < 16, j < 64) of the generators: the same
    points as g1_mul / g2_mul with ~60 additions each instead of ~380."""

    def __init__(self):
        self.g1 = self._tables(ZG1, z_g1_add)
        self.g2 = self._tables(ZG2, z_g2_add)

    @staticmethod
    def _tables(gen, add):
        tabs, base = [], gen
        for _ in range(64):
            row = [None]
            for _ in range(15):
                row.append(add(row[-1], base))
            tabs.append(row)
            base = add(row[-1], base)
        return tabs

    @staticmethod
    def _mul(tabs, add, k):
        acc = None
        for j in range(64):
            acc = add(acc, tabs[j][(k >> (4 * j)) & 15])
        return acc

    def fixed_base_g1(self, scalars):
        return [self._mul(self.g1, z_g1_add, s % R) for s in scalars]

    def fixed_base_g2(self, scalars):
        return [self._mul(self.g2, z_g2_add, s % R) for s in scalars]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test suite runs in several processes at
    once, where torch's thread pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain510():
    a, b, c, z = _chain_rows(510)
    zr1cs = ZR1CS(num_inputs=2, num_aux=510, input_names=["main.x"],
                  a_rows=a, b_rows=b, c_rows=c, var_of_signal=[])
    zparams = z_generate_parameters(zr1cs, **TOXIC, engine=_FixedBase())
    r1cs = r1cs_from_arrays({
        "a": _csr(a), "b": _csr(b), "c": _csr(c), "num_inputs": 2,
        "num_aux": 510, "input_names": ["main.x"],
    })
    params = params_from_arrays(params_to_arrays(zparams))
    return zr1cs, zparams, r1cs, params, z


def _expected_proof(zr1cs, z, domain_size, r, s):
    """za_tpu's proof for these r, s, in closed form from the toxic
    waste: every MSM is a scalar times the generator."""
    tau, alpha, beta = TOXIC["tau"], TOXIC["alpha"], TOXIC["beta"]
    delta = TOXIC["delta"]
    u, v, w = qap_evals_at_tau(zr1cs, tau, ZDomain(domain_size))
    ni = zr1cs.num_inputs
    A = sum(zi * ui for zi, ui in zip(z, u)) % R
    B = sum(zi * vi for zi, vi in zip(z, v)) % R
    C = sum(zi * wi for zi, wi in zip(z, w)) % R
    lsum = sum(z[i] * (beta * u[i] + alpha * v[i] + w[i])
               for i in range(ni, zr1cs.num_vars)) % R
    dinv = pow(delta, -1, R)
    pa = (alpha + A + r * delta) % R
    pb = (beta + B + s * delta) % R
    pc = ((lsum + A * B - C) * dinv + s * pa + r * pb - r * s * delta) % R
    return z_g1_mul(ZG1, pa), z_g2_mul(ZG2, pb), z_g1_mul(ZG1, pc)


@pytest.mark.parametrize("route", ["dense", "tree", "fused"])
def test_prove_matches_reference_and_verifies(chain510, route, monkeypatch):
    """The MSM routes of the staged branch: at 512 padded points the
    dense kernel (g1x4), the tree once TREE_MIN is lowered, and the
    dense radix-4 kernel of msm_style="fused"."""
    zr1cs, zparams, r1cs, params, z = chain510
    if route == "tree":
        monkeypatch.setattr(engine_mod, "TREE_MIN", 0)
    eng = GpuEngine(device="cpu",
                    msm_style="fused" if route == "fused" else None)
    proof = prove(params, r1cs, z, r=13, s=17, engine=eng)
    staged = params._staged_cache[1]
    if route == "tree":
        assert "g1abl" in staged
    else:
        assert staged["g1x4"].radix == (4 if route == "fused" else 16)
    want_a, want_b, want_c = _expected_proof(zr1cs, z, params.domain_size,
                                             13, 17)
    zb = (ZFq2(proof.b[0].c0, proof.b[0].c1),
          ZFq2(proof.b[1].c0, proof.b[1].c1))
    assert (proof.a, zb, proof.c) == (want_a, want_b, want_c)
    assert z_verify_proof(zparams.vk, ZProof(a=proof.a, b=zb, c=proof.c),
                          z[1:2])
    assert verify_proof(params.vk, proof, z[1:2])
    assert not verify_proof(params.vk, proof, [(z[1] + 1) % R])


def test_small_circuit_takes_the_host_path():
    """Below the staged gate the prover keeps every stage on the host,
    also when handed the device engine."""
    a, b, c, z = _chain_rows(3)
    r1cs = r1cs_from_arrays({
        "a": _csr(a), "b": _csr(b), "c": _csr(c), "num_inputs": 2,
        "num_aux": 3, "input_names": ["main.x"],
    })
    params = generate_parameters(r1cs, **TOXIC)
    p_dev = prove(params, r1cs, z, r=5, s=6, engine=GpuEngine(device="cpu"))
    p_host = prove(params, r1cs, z, r=5, s=6, engine=HostEngine())
    assert (p_dev.a, p_dev.b, p_dev.c) == (p_host.a, p_host.b, p_host.c)
    assert verify_proof(params.vk, p_dev, z[1:2])
    assert not hasattr(params, "_staged_cache")


def test_stage_cache_is_keyed_by_style(chain510):
    """A params object staged by a fused-style engine is restaged, not
    reused, by a default engine: the two stage other multiples."""
    _, _, r1cs, params, _ = chain510
    fused = GpuEngine(device="cpu", msm_style="fused").stage_params(
        params, r1cs)
    assert fused["g1x4"].radix == 4
    default = GpuEngine(device="cpu").stage_params(params, r1cs)
    assert default is not fused and default["g1x4"].radix == 16
    assert GpuEngine(device="cpu").stage_params(params, r1cs) is default
