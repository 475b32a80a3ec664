"""Host-side BN254 (a.k.a. BN128/bn256) curve arithmetic and pairing.

Implements from spec the functionality the reference delegates to its
``pairing_ce``/``bellman_ce`` forks (prover/Cargo.toml:19-20): Fq/Fq2/
Fq6/Fq12 tower, G1/G2 affine group law, scalar multiplication, and the
optimal ate pairing with final exponentiation. Exact host reference for
the CUDA kernels (za_tpu_torch.engine) and the verification path.

Curve: y^2 = x^3 + 3 over Fq; twist: y^2 = x^3 + 3/(9+i) over Fq2
(D-type sextic twist, xi = 9+i).

BN parameter u = 4965661367192848881:
  q = 36u^4 + 36u^3 + 24u^2 + 6u + 1
  r = 36u^4 + 36u^3 + 18u^2 + 6u + 1
"""

from __future__ import annotations

from typing import Optional, Union

BN_U = 4965661367192848881
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

assert Q == 36 * BN_U**4 + 36 * BN_U**3 + 24 * BN_U**2 + 6 * BN_U + 1
assert R == 36 * BN_U**4 + 36 * BN_U**3 + 18 * BN_U**2 + 6 * BN_U + 1

# 2-adicity of r-1 and a generator of the multiplicative group of Fr
# (verified in tests against the known factorization of r-1)
FR_TWO_ADICITY = 28
FR_GENERATOR = 5
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


# -- Fq2 = Fq[i]/(i^2+1) -----------------------------------------------------


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % Q
        self.c1 = c1 % Q

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: Union["Fq2", int]) -> "Fq2":
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        # (a0 + a1 i)(b0 + b1 i) = a0b0 - a1b1 + (a0b1 + a1b0) i
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    __rmul__ = __mul__

    def square(self) -> "Fq2":
        a0, a1 = self.c0, self.c1
        return Fq2(a0 * a0 - a1 * a1, 2 * a0 * a1)

    def conj(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inv(self) -> "Fq2":
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % Q
        ninv = _inv(norm, Q)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def mul_xi(self) -> "Fq2":
        """Multiply by xi = 9 + i."""
        return Fq2(9 * self.c0 - self.c1, self.c0 + 9 * self.c1)

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __repr__(self) -> str:
        return f"Fq2({self.c0},{self.c1})"


XI = Fq2(9, 1)

# Frobenius constants: xi^((q-1)/k) powers
FROB_FQ6_C1 = XI.pow((Q - 1) // 3)       # for v coefficient
FROB_FQ6_C2 = XI.pow(2 * (Q - 1) // 3)   # for v^2 coefficient
FROB_FQ12_C1 = XI.pow((Q - 1) // 6)      # for w coefficient


# -- Fq6 = Fq2[v]/(v^3 - xi) -------------------------------------------------


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_xi()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_fq2(self, s: Fq2) -> "Fq6":
        return Fq6(self.c0 * s, self.c1 * s, self.c2 * s)

    def mul_v(self) -> "Fq6":
        """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
        return Fq6(self.c2.mul_xi(), self.c0, self.c1)

    def square(self) -> "Fq6":
        return self * self

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_xi()
        t1 = a2.square().mul_xi() - a0 * a1
        t2 = a1.square() - a0 * a2
        norm = a0 * t0 + (a2 * t1).mul_xi() + (a1 * t2).mul_xi()
        ninv = norm.inv()
        return Fq6(t0 * ninv, t1 * ninv, t2 * ninv)

    def frob(self) -> "Fq6":
        return Fq6(
            self.c0.conj(),
            self.c1.conj() * FROB_FQ6_C1,
            self.c2.conj() * FROB_FQ6_C2,
        )

    def __repr__(self) -> str:
        return f"Fq6({self.c0},{self.c1},{self.c2})"


# -- Fq12 = Fq6[w]/(w^2 - v) -------------------------------------------------


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    def is_one(self) -> bool:
        return self == Fq12.one()

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq12(t0 + t1.mul_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self) -> "Fq12":
        return self * self

    def conj(self) -> "Fq12":
        """Conjugation = Frobenius^6; inverse in the cyclotomic subgroup."""
        return Fq12(self.c0, -self.c1)

    def inv(self) -> "Fq12":
        t = (self.c0.square() - self.c1.square().mul_v()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def frob(self, k: int = 1) -> "Fq12":
        out = self
        for _ in range(k):
            out = Fq12(out.c0.frob(), out.c1.frob().mul_fq2(FROB_FQ12_C1))
        return out

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def __repr__(self) -> str:
        return f"Fq12({self.c0},{self.c1})"


# -- group law (generic affine, points are (x, y) tuples or None) ------------

#: G1 points: coordinates are ints mod Q. G2 points: coordinates are Fq2.
G1Point = Optional[tuple[int, int]]
G2Point = Optional[tuple[Fq2, Fq2]]

G1_GEN: G1Point = (1, 2)
G2_GEN: G2Point = (
    Fq2(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    Fq2(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

B1 = 3
B2 = Fq2(3, 0) * Fq2(9, 1).inv()  # 3 / (9 + i)


def _is_fq2(x) -> bool:
    return isinstance(x, Fq2)


def g1_is_on_curve(p: G1Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B1) % Q == 0


def g2_is_on_curve(p: G2Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y.square() - x * x.square() - B2).is_zero()


def _ec_add(p1, p2, zero_test, inv_fn):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if zero_test(x1 - x2):
        if zero_test(y1 + y2):
            return None
        # doubling
        m = (3 * x1 * x1 if not _is_fq2(x1) else x1.square() * 3) * inv_fn(y1 + y1)
        x3 = m * m - x1 - x2 if not _is_fq2(x1) else m.square() - x1 - x2
        y3 = m * (x1 - x3) - y1
    else:
        m = (y2 - y1) * inv_fn(x2 - x1)
        x3 = m * m - x1 - x2 if not _is_fq2(x1) else m.square() - x1 - x2
        y3 = m * (x1 - x3) - y1
    return (x3, y3)


def g1_add(p1: G1Point, p2: G1Point) -> G1Point:
    r = _ec_add(
        None if p1 is None else (p1[0] % Q, p1[1] % Q),
        None if p2 is None else (p2[0] % Q, p2[1] % Q),
        lambda v: v % Q == 0,
        lambda v: _inv(v % Q, Q),
    )
    return None if r is None else (r[0] % Q, r[1] % Q)


def g1_neg(p: G1Point) -> G1Point:
    return None if p is None else (p[0], (-p[1]) % Q)


def g1_mul(p: G1Point, k: int) -> G1Point:
    k %= R
    result: G1Point = None
    add = p
    while k:
        if k & 1:
            result = g1_add(result, add)
        add = g1_add(add, add)
        k >>= 1
    return result


def g2_add(p1: G2Point, p2: G2Point) -> G2Point:
    return _ec_add(p1, p2, lambda v: v.is_zero(), lambda v: v.inv())


def g2_neg(p: G2Point) -> G2Point:
    return None if p is None else (p[0], -p[1])


def g2_mul(p: G2Point, k: int) -> G2Point:
    result: G2Point = None
    add = p
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_add(add, add)
        k >>= 1
    return result


# -- optimal ate pairing -----------------------------------------------------

ATE_LOOP_COUNT = 6 * BN_U + 2

# Frobenius twist constants for G2 points in Fq2 coordinates:
#   pi(x, y) = (conj(x) * xi^((q-1)/3), conj(y) * xi^((q-1)/2))
FROB_TW_X = XI.pow((Q - 1) // 3)
FROB_TW_Y = XI.pow((Q - 1) // 2)


def g2_frob(p: G2Point) -> G2Point:
    if p is None:
        return None
    x, y = p
    return (x.conj() * FROB_TW_X, y.conj() * FROB_TW_Y)


def _line_eval(
    r: tuple[Fq2, Fq2], q2: tuple[Fq2, Fq2], px: int, py: int, doubling: bool
) -> tuple[Fq12, tuple[Fq2, Fq2]]:
    """Line through R,Q (or tangent at R) on the twist, evaluated at the
    G1 point P; returns (line value in Fq12, R+Q or 2R).

    With the untwist psi(x,y) = (x*w^2, y*w^3), the slope in Fq12 is
    m12 = m*w (m the Fq2 slope on the twist), so the affine line
    l = (Y_P - y_r*w^3) - m*w*(X_P - x_r*w^2) evaluated at (px, py) is
      py - m*px*w + (m*x_r - y_r)*w^3
    which in the Fq6[w] basis (w^2 = v, w^3 = v*w) is
      c0 = (py, 0, 0), c1 = (-m*px, m*x_r - y_r, 0).
    """
    xr, yr = r
    if doubling:
        m = xr.square() * 3 * (yr + yr).inv()
    else:
        xq, yq = q2
        if (xr - xq).is_zero():
            if (yr + yq).is_zero():
                # vertical line: l = X - x_r = px - x_r*w^2
                c0 = Fq6(Fq2(px, 0), -xr, Fq2.zero())
                return Fq12(c0, Fq6.zero()), None
            m = xr.square() * 3 * (yr + yr).inv()
        else:
            m = (yr - yq) * (xr - xq).inv()
    # next point
    xq, yq = q2 if not doubling else r
    x3 = m.square() - xr - xq
    y3 = m * (xr - x3) - yr
    c0 = Fq6(Fq2(py, 0), Fq2.zero(), Fq2.zero())
    c1 = Fq6(m * Fq2(-px, 0), m * xr - yr, Fq2.zero())
    return Fq12(c0, c1), (x3, y3)


def miller_loop(q2: G2Point, p1: G1Point) -> Fq12:
    """Optimal ate Miller loop f_{6u+2,Q}(P) with the two Frobenius
    correction lines."""
    if q2 is None or p1 is None:
        return Fq12.one()
    px, py = p1
    f = Fq12.one()
    r = q2
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip MSB
    for bit in bits:
        line, r = _line_eval(r, r, px, py, doubling=True)
        f = f.square() * line
        if bit == "1":
            line, r = _line_eval(r, q2, px, py, doubling=False)
            f = f * line
    q1 = g2_frob(q2)
    nq2 = g2_neg(g2_frob(q1))
    line, r = _line_eval(r, q1, px, py, doubling=False)
    f = f * line
    line, r = _line_eval(r, nq2, px, py, doubling=False)
    f = f * line
    return f


def _hard_part_bn(t: Fq12) -> Fq12:
    """Scott-Benger-Charlemagne-Dominguez-Kachisa addition chain for
    the BN hard part (q^4-q^2+1)/r in terms of the curve parameter u:
    3 u-exponentiations + ~15 Fq12 muls instead of a ~1020-bit plain
    power. After the easy part t lies in the cyclotomic subgroup, so
    inversion is conjugation (t^(q^6) = t^-1)."""
    fz = t.pow(BN_U)
    fz2 = fz.pow(BN_U)
    fz3 = fz2.pow(BN_U)
    y0 = t.frob(1) * t.frob(2) * t.frob(3)
    y1 = t.conj()
    y2 = fz2.frob(2)
    y3 = fz.frob(1).conj()
    y4 = (fz2.frob(1) * fz).conj()
    y5 = fz2.conj()
    y6 = (fz3.frob(1) * fz3).conj()
    t0 = y6.square() * y4 * y5
    t1 = y3 * y5 * t0
    t0 = t0 * y2
    t1 = (t1.square() * t0).square()
    t0 = t1 * y1
    t1 = t1 * y0
    t0 = t0.square()
    return t0 * t1


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((q^12-1)/r) via easy part (q^6-1)(q^2+1) then the BN
    addition-chain hard part."""
    # easy part
    t = f.conj() * f.inv()          # f^(q^6 - 1)
    t = t.frob(2) * t               # ^(q^2 + 1)
    return _hard_part_bn(t)


def pairing(q2: G2Point, p1: G1Point) -> Fq12:
    return final_exponentiation(miller_loop(q2, p1))


def multi_pairing(pairs: list[tuple[G1Point, G2Point]]) -> Fq12:
    """prod e(P_i, Q_i) with a single final exponentiation."""
    f = Fq12.one()
    for p1, q2 in pairs:
        f = f * miller_loop(q2, p1)
    return final_exponentiation(f)
