"""BN254 in plain Python ints: the fields, G1 and G2 in Jacobian
coordinates, and fixed-base scalar multiplication by window tables.

A frozen, self-contained copy of the curve's definition for the
benchmark's reference; it imports nothing of the prover under test.

Curve: y^2 = x^3 + 3 over Fq; twist y^2 = x^3 + 3 / (9 + i) over
Fq2 = Fq[i] / (i^2 + 1).  An Fq2 element is a pair (c0, c1) of ints.
Affine points are tuples (x, y), None at infinity; Jacobian points are
(X, Y, Z) with Z = 0 at infinity.
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

G1 = (1, 2)
G2 = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


class Fq:
    """Fq's operations on ints, the interface the group law is written on."""

    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def sqr(a):
        return a * a % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)

    @staticmethod
    def small(a, k):
        return a * k % Q


class Fq2:
    """Fq2 = Fq[i] / (i^2 + 1) on pairs of ints."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q,
                (a[0] * b[1] + a[1] * b[0]) % Q)

    @staticmethod
    def sqr(a):
        return ((a[0] + a[1]) * (a[0] - a[1]) % Q, 2 * a[0] * a[1] % Q)

    @staticmethod
    def inv(a):
        t = pow(a[0] * a[0] + a[1] * a[1], -1, Q)
        return (a[0] * t % Q, -a[1] * t % Q)

    @staticmethod
    def small(a, k):
        return (a[0] * k % Q, a[1] * k % Q)


B1 = 3
B2 = Fq2.mul((3, 0), Fq2.inv((9, 1)))


def on_curve(p, F) -> bool:
    if p is None:
        return True
    x, y = p
    b = B1 if F is Fq else B2
    return F.sqr(y) == F.add(F.mul(F.sqr(x), x), b)


def _is_zero(a, F) -> bool:
    return a == F.zero


def jac(p, F):
    return (F.zero, F.one, F.zero) if p is None else (p[0], p[1], F.one)


def double(P, F):
    """2P (dbl-2009-l, a = 0)."""
    X, Y, Z = P
    if _is_zero(Z, F):
        return P
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.small(F.sub(F.sub(F.sqr(F.add(X, B)), A), C), 2)
    E = F.small(A, 3)
    X3 = F.sub(F.sqr(E), F.small(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.small(C, 8))
    return X3, Y3, F.small(F.mul(Y, Z), 2)


def add(P, Qp, F):
    """P + Q (add-2007-bl), doubling and infinity handled."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Qp
    if _is_zero(Z1, F):
        return Qp
    if _is_zero(Z2, F):
        return P
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    rr = F.small(F.sub(S2, S1), 2)
    if _is_zero(H, F):
        return double(P, F) if _is_zero(rr, F) else (F.zero, F.one, F.zero)
    I = F.sqr(F.small(H, 2))
    J = F.mul(H, I)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.small(V, 2))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.small(F.mul(S1, J), 2))
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return X3, Y3, Z3


def affine(P, F):
    X, Y, Z = P
    if _is_zero(Z, F):
        return None
    zi = F.inv(Z)
    zi2 = F.sqr(zi)
    return F.mul(X, zi2), F.mul(F.mul(Y, zi2), zi)


class FixedBase:
    """k * base for any k mod r by a table of 4-bit windows:
    T[w][d] = d 16^w base, d = 1..15, w = 0..63; one add a window."""

    def __init__(self, base, F):
        self.F = F
        self.table = []
        b = jac(base, F)
        for _ in range(64):
            row = [b]
            for _ in range(14):
                row.append(add(row[-1], b, F))
            self.table.append(row)
            for _ in range(4):
                b = double(b, F)

    def mul_jac(self, k: int):
        F = self.F
        k %= R
        acc = (F.zero, F.one, F.zero)
        w = 0
        while k:
            d = k & 15
            if d:
                acc = add(acc, self.table[w][d - 1], F)
            k >>= 4
            w += 1
        return acc

    def mul(self, k: int):
        return affine(self.mul_jac(k), self.F)

    def mul_many(self, ks):
        """Affine k_i * base for every k_i, one field inversion in all."""
        F = self.F
        pts = [self.mul_jac(k) for k in ks]
        zs = [p[2] for p in pts]
        live = [i for i, z in enumerate(zs) if not _is_zero(z, F)]
        out = [None] * len(pts)
        if not live:
            return out
        pref = [F.one]
        for i in live:
            pref.append(F.mul(pref[-1], zs[i]))
        inv = F.inv(pref[-1])
        for j in range(len(live) - 1, -1, -1):
            i = live[j]
            zi = F.mul(inv, pref[j])
            inv = F.mul(inv, zs[i])
            zi2 = F.sqr(zi)
            X, Y, _ = pts[i]
            out[i] = (F.mul(X, zi2), F.mul(F.mul(Y, zi2), zi))
        return out
