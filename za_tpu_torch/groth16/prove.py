"""Groth16 prover (create_random_proof equivalent).

Pipeline: witness z -> Az/Bz/Cz on the domain -> iNTT -> coset NTT ->
h = (a*b - c)/Z on coset -> coset iNTT -> five MSMs -> (A, B, C).

All heavy stages route through a compute engine (the exact host engine
below, or ``engine.engine.GpuEngine``); randomness r, s can be pinned
for deterministic replay.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..curve import G1Point, G2Point, R, g1_add, g1_mul, g2_add, g2_mul
from .domain import Domain
from .r1cs import R1CS
from .setup import Groth16Parameters, expand_queries


#: below this many variables and domain points every stage stays on the
#: host: device offload buys nothing there
STAGED_MIN = 512


@dataclass
class Proof:
    a: G1Point
    b: G2Point
    c: G1Point


class HostEngine:
    """Exact Python-int compute engine: golden reference for the device
    engine and the path for tiny circuits."""

    def msm_g1(self, points: list[G1Point], scalars: list[int]) -> G1Point:
        acc = None
        for p, s in zip(points, scalars):
            if p is None or s % R == 0:
                continue
            acc = g1_add(acc, g1_mul(p, s))
        return acc

    def msm_g2(self, points: list[G2Point], scalars: list[int]) -> G2Point:
        acc = None
        for p, s in zip(points, scalars):
            if p is None or s % R == 0:
                continue
            acc = g2_add(acc, g2_mul(p, s))
        return acc

    def h_coeffs(self, r1cs: R1CS, z: list[int], domain: Domain) -> list[int]:
        """QAP quotient polynomial coefficients h_0..h_{m-2}."""
        m = domain.size
        az = [0] * m
        bz = [0] * m
        cz = [0] * m
        eaz, ebz, ecz = r1cs.eval_constraints(z)
        n = r1cs.num_constraints
        az[:n] = eaz
        bz[:n] = ebz
        cz[:n] = ecz
        for i in range(r1cs.num_inputs):
            az[n + i] = z[i]

        a_c = domain.coset_ntt(domain.intt(az))
        b_c = domain.coset_ntt(domain.intt(bz))
        c_c = domain.coset_ntt(domain.intt(cz))
        zinv = domain.z_coset_inv
        h_c = [(a * b - c) * zinv % R for a, b, c in zip(a_c, b_c, c_c)]
        h = domain.coset_intt(h_c)
        assert h[m - 1] == 0, "h(x) degree overflow: witness unsatisfied?"
        return h[: m - 1]


def _materialize_raw(params: Groth16Parameters) -> Groth16Parameters:
    """Raw limb-array queries -> host point lists, for engine paths that
    consume Python points."""
    if not hasattr(params.a, "to_points"):
        return params
    from dataclasses import replace

    return replace(
        params,
        h=params.h.to_points(),
        l=params.l.to_points(),
        a=params.a.to_points(),
        b_g1=params.b_g1.to_points(),
        b_g2=params.b_g2.to_points(),
    )


def prove(
    params: Groth16Parameters,
    r1cs: R1CS,
    z: list[int],
    r: int | None = None,
    s: int | None = None,
    engine=None,
) -> Proof:
    engine = engine if engine is not None else HostEngine()
    r = r if r is not None else secrets.randbelow(R)
    s = s if s is not None else secrets.randbelow(R)

    domain = Domain(params.domain_size)
    ni = r1cs.num_inputs
    vk = params.vk
    staged_path = (
        hasattr(engine, "stage_params")
        and getattr(engine, "use_grouped", False)
        and max(r1cs.num_vars, params.domain_size - 1) >= STAGED_MIN
    )
    if not staged_path and hasattr(engine, "stage_params"):
        engine = HostEngine()  # a device engine serves staged sizes only

    if staged_path:
        # device-resident pk: queries staged once per process (cached
        # on params), the witness uploaded once and shared
        h = engine.h_coeffs_limbs(r1cs, z, domain)  # stays on the device
        staged = engine.stage_params(params, r1cs)
        z_l = engine.witness_limbs_dev(z)
        if "g1abl" in staged:  # batch-affine tree staging: h separate
            a_acc, b_acc_g1, l_acc = engine.msm_g1_many(
                staged["g1abl"], [z_l, z_l, z_l[:, ni:]],
            )
            h_acc = engine.msm_g1_many(staged["g1h"], [h])[0]
        else:  # dense: the four G1 queries stacked, one kernel
            a_acc, b_acc_g1, l_acc, h_acc = engine.msm_g1_many(
                staged["g1x4"], [z_l, z_l, z_l[:, ni:], h],
            )
        b_acc_g2 = engine.msm_g2_many(staged["b_g2x"], [z_l])[0]
    else:
        h = engine.h_coeffs(r1cs, z, domain)
        params = expand_queries(params, r1cs)  # undo pk density filtering
        params = _materialize_raw(params)
        a_acc = engine.msm_g1(params.a, z)
        b_acc_g2 = engine.msm_g2(params.b_g2, z)
        b_acc_g1 = engine.msm_g1(params.b_g1, z)
        l_acc = engine.msm_g1(params.l, z[ni:])
        h_acc = engine.msm_g1(params.h, h)

    # A = alpha + sum z_i u_i(tau) + r*delta
    proof_a = g1_add(g1_add(vk.alpha_g1, a_acc), g1_mul(vk.delta_g1, r))

    # B = beta + sum z_i v_i(tau) + s*delta  (G2), B1 same in G1
    proof_b = g2_add(g2_add(vk.beta_g2, b_acc_g2), g2_mul(vk.delta_g2, s))
    b1 = g1_add(g1_add(vk.beta_g1, b_acc_g1), g1_mul(vk.delta_g1, s))

    # C = sum_aux z_i L_i + sum h_i H_i + s*A + r*B1 - r*s*delta
    c = g1_add(l_acc, h_acc)
    c = g1_add(c, g1_mul(proof_a, s))
    c = g1_add(c, g1_mul(b1, r))
    c = g1_add(c, g1_mul(vk.delta_g1, (R - r * s % R) % R))

    return Proof(a=proof_a, b=proof_b, c=c)
