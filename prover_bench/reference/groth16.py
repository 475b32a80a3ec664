"""The expected Groth16 proof for the benchmark's pool proving key.

The proving key's points have discrete logs the benchmark drew itself
(``prover_bench/inputs.py``): query ``q``'s point ``i`` is
``logs[q][i mod P_q]`` times the generator, and the h query's point
``i`` is ``k tau^i`` times it, with ``tau`` of odd prime order ``P_h``
dividing ``r - 1``.  So each of the prover's five MSMs has one exact
scalar as its value:

- a, b1, b2: ``sum_i z_i logs[i mod P]``; l the same over the aux
  variables;
- h: ``sum_i h_i k tau^i = k h(tau)``, and by the QAP identity
  ``h(tau) = (A(tau) B(tau) - C(tau)) / Z(tau)``, where ``A`` is the
  polynomial through the A leg's values at the domain's points
  ``omega^j`` (row j; the input-preservation rows ``n + i`` hold
  ``z_i``), and ``Z(x) = x^m - 1``.  ``A(tau)`` comes from the Lagrange
  basis at tau, ``L_j(tau) = (Z(tau) / m) omega^j / (tau - omega^j)``.

The proof is then ``A = (alpha + a + r delta) G1``, ``B = (beta + b2 +
s delta) G2`` and ``C = (l + k h(tau) + s pa + r pb1 - r s delta) G1``
with ``pb1 = beta + b1 + s delta``: every point exact, worked out from
the constraint rows, the witness and the logs alone.  The domain is
bellman's: ``omega`` of order m a power of the 2^28-th root of unity
``5^((r - 1) / 2^28)``.  Plain Python ints; nothing of the prover.
"""

from __future__ import annotations

import operator

from .bn254 import G1, G2, R, FixedBase, Fq, Fq2

ROOT_2_28 = pow(5, (R - 1) >> 28, R)


def domain_size(num_constraints: int, num_inputs: int) -> int:
    m = 1
    while m < num_constraints + num_inputs:
        m <<= 1
    return m


def omega(m: int) -> int:
    return pow(ROOT_2_28, (1 << 28) // m, R)


def dot(xs, ys) -> int:
    return sum(map(operator.mul, xs, ys)) % R


def pooled(z, logs) -> int:
    """sum_i z_i logs[i mod P], grouped by residue class."""
    P = len(logs)
    return sum(sum(z[c::P]) % R * logs[c] for c in range(P)) % R


class QAPAtTau:
    """Each variable's u, v and w at tau, scaled by m / Z(tau):
    ``A(tau) = (Z(tau) / m) sum_k z_k u_k`` for any witness z."""

    def __init__(self, circuit: dict, tau: int):
        n = len(circuit["a"])
        ni = circuit["num_inputs"]
        nv = ni + circuit["num_aux"]
        self.m = m = domain_size(n, ni)
        rows = n + ni
        w = omega(m)
        pw = [0] * rows
        x = 1
        for j in range(rows):
            pw[j] = x
            x = x * w % R
        den = [(tau - v) % R for v in pw]
        if not all(den):
            raise ValueError("tau lies on the domain")
        pref = [0] * rows
        acc = 1
        for j in range(rows):
            pref[j] = acc
            acc = acc * den[j] % R
        inv = pow(acc, -1, R)
        lam = [0] * rows     # omega^j / (tau - omega^j)
        for j in range(rows - 1, -1, -1):
            lam[j] = inv * pref[j] % R * pw[j] % R
            inv = inv * den[j] % R
        self.legs = []
        for leg in ("a", "b", "c"):
            u = [0] * nv
            for j, row in enumerate(circuit[leg]):
                lj = lam[j]
                for var, coef in row:
                    u[var] += coef * lj
            if leg == "a":
                for i in range(ni):
                    u[i] += lam[n + i]
            self.legs.append([v % R for v in u])
        self.z_tau = (pow(tau, m, R) - 1) % R
        self.scale = self.z_tau * pow(m, -1, R) % R

    def h_at_tau(self, z) -> int:
        a, b, c = (self.scale * dot(z, u) % R for u in self.legs)
        return (a * b - c) * pow(self.z_tau, -1, R) % R


class Expected:
    """The exact proof of every (witness, r, s) for one pool pk."""

    def __init__(self, circuit: dict, logs: dict):
        self.logs = logs
        self.ni = circuit["num_inputs"]
        self.qap = QAPAtTau(circuit, logs["tau"])
        self.g1 = FixedBase(G1, Fq)
        self.g2 = FixedBase(G2, Fq2)

    def terms(self, z, mask: int | None = None) -> dict:
        """The five MSMs' values for witness z as scalars.  ``mask``
        (the control's) keeps only those bits of each witness value in
        the MSMs over the witness."""
        lg = self.logs
        zs = z if mask is None else [v & mask for v in z]
        return {"a": pooled(zs, lg["a"]), "b1": pooled(zs, lg["b1"]),
                "b2": pooled(zs, lg["b2"]),
                "l": pooled(zs[self.ni:], lg["l"]),
                "h": lg["k"] * self.qap.h_at_tau(z) % R}

    def scalars(self, t: dict, r: int, s: int) -> tuple[int, int, int]:
        lg = self.logs
        al, be, de = lg["alpha"], lg["beta"], lg["delta"]
        pa = (al + t["a"] + r * de) % R
        pb = (be + t["b2"] + s * de) % R
        pb1 = (be + t["b1"] + s * de) % R
        pc = (t["l"] + t["h"] + s * pa + r * pb1 - r * s * de) % R
        return pa, pb, pc

    def points(self, t: dict, r: int, s: int):
        pa, pb, pc = self.scalars(t, r, s)
        a, c = self.g1.mul_many([pa, pc])
        return a, self.g2.mul(pb), c


def judge(expected: Expected, witnesses, proofs) -> dict:
    """Count the proofs whose A, B or C differs from the reference's.
    ``proofs``: (witness index, r, s, (A, B, C)) with affine points as
    plain tuples (G2 coordinates as (c0, c1) pairs), None at infinity."""
    terms = {}
    wrong = {"A": 0, "B": 0, "C": 0}
    for k, r, s, got in proofs:
        if k not in terms:
            terms[k] = expected.terms(witnesses[k])
        want = expected.points(terms[k], r, s)
        for name, g, w in zip("ABC", got, want):
            if g != w:
                wrong[name] += 1
    return wrong


def control_proofs(expected: Expected, witnesses, draws, mask: int):
    """The control in the prover's place: the reference's proofs with
    each witness value cut to ``mask``'s bits in the witness MSMs."""
    terms = {}
    out = []
    for k, r, s in draws:
        if k not in terms:
            terms[k] = expected.terms(witnesses[k], mask)
        out.append((k, r, s, expected.points(terms[k], r, s)))
    return out
