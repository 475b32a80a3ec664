"""Groth16 trusted setup (generate_random_parameters equivalent).

Builds the proving/verifying key for an R1CS: QAP polynomials evaluated
at tau via Lagrange coefficients, then the G1/G2 query vectors by an
engine's fixed-base batch scalar multiplication (``GpuEngine``: kernels
on the card) or, without one, by host scalar multiplication (fine for
small circuits); exact either way.

Domain layout matches bellman: one extra constraint row per public input
(input i appears alone in A) to prevent input malleability; domain size
is the next power of two >= num_constraints + num_inputs.
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, replace

from ..curve import G1_GEN, G2_GEN, G1Point, G2Point, R, g1_mul, g2_mul
from .domain import Domain, batch_inverse
from .r1cs import R1CS


@dataclass
class VerifyingKey:
    alpha_g1: G1Point
    beta_g1: G1Point
    beta_g2: G2Point
    gamma_g2: G2Point
    delta_g1: G1Point
    delta_g2: G2Point
    ic: list[G1Point]  # input commitments: (beta*u_i + alpha*v_i + w_i)/gamma


@dataclass
class Groth16Parameters:
    """Query vectors are host point lists (None = infinity) or the raw
    limb-array queries of ``groth16.format``."""

    vk: VerifyingKey
    h: list[G1Point]       # (tau^i * Z(tau))/delta,     i in 0..m-2
    l: list[G1Point]       # (beta*u_i+alpha*v_i+w_i)/delta for aux vars
    a: list[G1Point]       # u_i(tau) * G1 for all vars  (None if zero)
    b_g1: list[G1Point]    # v_i(tau) * G1 for all vars
    b_g2: list[G2Point]    # v_i(tau) * G2 for all vars
    domain_size: int


def qap_evals_at_tau(r1cs: R1CS, tau: int, domain: Domain):
    """u_i(tau), v_i(tau), w_i(tau) per variable via Lagrange evaluation
    (sparse accumulation over constraint rows)."""
    lag = domain.lagrange_at(tau)
    nv = r1cs.num_vars
    u = [0] * nv
    v = [0] * nv
    w = [0] * nv
    for k in range(r1cs.num_constraints):
        lk = lag[k]
        for var, coeff in r1cs.a_rows[k]:
            u[var] = (u[var] + coeff * lk) % R
        for var, coeff in r1cs.b_rows[k]:
            v[var] = (v[var] + coeff * lk) % R
        for var, coeff in r1cs.c_rows[k]:
            w[var] = (w[var] + coeff * lk) % R
    # input-preservation rows (bellman generator.rs): input i alone in A
    for i in range(r1cs.num_inputs):
        lk = lag[r1cs.num_constraints + i]
        u[i] = (u[i] + lk) % R
    return u, v, w


def expand_queries(params: Groth16Parameters, r1cs: R1CS) -> Groth16Parameters:
    """Undo bellman's density filtering: a pk may store only the
    density-selected a/b query points; the prover wants full
    per-variable vectors (infinity at non-dense slots).  No-op if the
    vectors are already full."""
    nv = r1cs.num_vars
    if len(params.a) == nv and len(params.b_g1) == nv and len(params.b_g2) == nv:
        return params
    a_d, b_d = r1cs.densities()

    def expand(vec, dense):
        if hasattr(vec, "expand"):  # raw limb-array query
            return vec.expand(dense)
        if len(vec) == len(dense):
            return vec
        if len(vec) != sum(dense):
            raise ValueError(
                f"query length {len(vec)} matches neither num_vars "
                f"{len(dense)} nor density count {sum(dense)}"
            )
        it = iter(vec)
        return [next(it) if d else None for d in dense]

    return replace(
        params,
        a=expand(params.a, a_d),
        b_g1=expand(params.b_g1, b_d),
        b_g2=expand(params.b_g2, b_d),
    )


def generate_parameters(
    r1cs: R1CS,
    tau: int | None = None,
    alpha: int | None = None,
    beta: int | None = None,
    gamma: int | None = None,
    delta: int | None = None,
    engine=None,
    timings: dict | None = None,
) -> Groth16Parameters:
    """Random toxic waste unless explicitly provided (deterministic
    tests).  With an engine the pk query points come from its
    fixed_base_g1 / fixed_base_g2, batch by batch in the reference's
    order; without one, from host scalar multiplication.

    ``timings``, when given, receives the seconds of each step:
    ``qap_evals_s`` (the QAP's values at tau), ``scalars_s`` (the query
    scalars), and under ``batches`` each batch's (ic, l, a, b_g1, h,
    b_g2, vk_g1, vk_g2) ``wall_s`` beside the engine's
    ``fixed_base_info`` split, if it has one."""
    t = timings if timings is not None else {}

    def rand_fr() -> int:
        while True:
            v = secrets.randbelow(R)
            if v != 0:
                return v

    tau = tau if tau is not None else rand_fr()
    alpha = alpha if alpha is not None else rand_fr()
    beta = beta if beta is not None else rand_fr()
    gamma = gamma if gamma is not None else rand_fr()
    delta = delta if delta is not None else rand_fr()

    domain = Domain.for_constraints(r1cs.num_constraints + r1cs.num_inputs)
    m = domain.size
    t0 = time.monotonic()
    u, v, w = qap_evals_at_tau(r1cs, tau, domain)
    t["qap_evals_s"] = time.monotonic() - t0
    t0 = time.monotonic()

    gamma_inv, delta_inv = batch_inverse([gamma, delta])
    z_tau = (pow(tau, m, R) - 1) % R

    ni = r1cs.num_inputs
    ic_s = [
        (beta * u[i] + alpha * v[i] + w[i]) * gamma_inv % R for i in range(ni)
    ]
    l_s = [
        (beta * u[i] + alpha * v[i] + w[i]) * delta_inv % R
        for i in range(ni, r1cs.num_vars)
    ]
    h_s = []
    p = z_tau * delta_inv % R
    for _ in range(m - 1):
        h_s.append(p)
        p = p * tau % R
    t["scalars_s"] = time.monotonic() - t0

    if engine is not None:
        g1_batch = engine.fixed_base_g1
        g2_batch = engine.fixed_base_g2
    else:

        def g1_batch(scalars):
            return [g1_mul(G1_GEN, s % R) for s in scalars]

        def g2_batch(scalars):
            return [g2_mul(G2_GEN, s % R) for s in scalars]

    batches = t["batches"] = {}

    def timed(name, mul_all, scalars):
        t0 = time.monotonic()
        out = mul_all(scalars)
        batches[name] = {"wall_s": time.monotonic() - t0,
                         **getattr(engine, "fixed_base_info", {})}
        return out

    ic = timed("ic", g1_batch, ic_s)
    l = timed("l", g1_batch, l_s)
    a = timed("a", g1_batch, u)
    b_g1 = timed("b_g1", g1_batch, v)
    h = timed("h", g1_batch, h_s)
    b_g2 = timed("b_g2", g2_batch, v)
    alpha_g1, beta_g1, delta_g1 = timed("vk_g1", g1_batch,
                                        [alpha, beta, delta])
    beta_g2, gamma_g2, delta_g2 = timed("vk_g2", g2_batch,
                                        [beta, gamma, delta])
    vk = VerifyingKey(
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g1=delta_g1,
        delta_g2=delta_g2,
        ic=ic,
    )
    return Groth16Parameters(
        vk=vk, h=h, l=l, a=a, b_g1=b_g1, b_g2=b_g2, domain_size=m,
    )
