"""The warp schedules of csrc/ec.cu's Horner kernels (namespace hw1 for
G1, hw2 for G2): their slot layouts and stage tables, parsed from the
source and run lane by lane in Python, give the coordinates of RCB
algorithm 7 (curve.cuh point_add) and the window combine of the host
curve."""

import random
import re
from pathlib import Path

import pytest

from za_tpu_torch.curve import (
    B2, G1_GEN, G2_GEN, Q, R, Fq2, g1_add, g1_mul, g2_add, g2_mul,
)

SRC = (Path(__file__).resolve().parent.parent / "za_tpu_torch" / "csrc"
       / "ec.cu").read_text()


class Schedule:
    """One namespace of ec.cu: its constexpr slots and int8 tables."""

    def __init__(self, ns: str, tables):
        self.src = SRC[SRC.index(f"namespace {ns} {{"):
                       SRC.index(f"}}  // namespace {ns}")]
        self.c = {k: int(v) for k, v in
                  re.findall(r"constexpr int (\w+) = (\d+);", self.src)}
        self.t = {n: self._table(n) for n in tables}

    def _table(self, name: str):
        body = re.search(r"const int8_t " + name + r"\[[^=]*= (\{.*?\});",
                         self.src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body).replace("{", "[")
        return eval(body.replace("}", "]"), {}, self.c)  # noqa: S307


HW = {"g1": Schedule("hw1", ("L1_OPS", "L3_OPS", "C1_TERMS", "C1_NINE",
                             "C1_POST", "C3_TERMS")),
      "g2": Schedule("hw2", ("L1_OPS", "L3_OPS", "C1_TERMS", "C2_TERMS",
                             "C2_KEEP", "C3_TERMS"))}


# -- G2: an Fq2 product as four Fq sub-products on four lanes ----------------


def _product_g2(s, out, np, a1, a2, b1, b2):
    """hw2::product for all 32 lanes: a1..b2 are per-lane slot lists."""
    res = {}
    for lane in range(32):
        q = lane & 3
        ca, cb = q & 1, (q ^ (q >> 1)) & 1
        a = (s[a1[lane] + ca] + s[a2[lane] + ca]) % Q
        b = (s[b1[lane] + cb] + s[b2[lane] + cb]) % Q
        if lane < 4 * np:
            res[out + lane] = a * b % Q
    s.update(res)


def _combine_g2(s, out, nv, L, terms, keep):
    C = HW["g2"].c
    res = {}
    for lane in range(32):
        v, c = min(lane >> 1, nv - 1), lane & 1
        r = s[(keep[v] if keep else C["ZERO"]) + c]
        for e in terms[v]:
            at = L + 4 * (abs(e) - 1) + 2 * c if e else C["ZERO"]
            k = (s[at] + s[at + 1]) if c else (s[at] - s[at + 1])
            r = (r - k if e < 0 else r + k) % Q
        if lane < 2 * nv:
            res[out + lane] = r
    s.update(res)


def _point_add_g2(s, qb):
    """hw2::point_add: acc (slots P) += the point at slots qb."""
    C, T = HW["g2"].c, HW["g2"].t
    P, Z = C["P"], C["ZERO"]
    j = [min(lane >> 2, 5) for lane in range(32)]
    o1 = [T["L1_OPS"][i][0] for i in j]
    o2 = [T["L1_OPS"][i][1] for i in j]
    _product_g2(s, C["L1"], 6, [P + o for o in o1],
                [Z if o < 0 else P + o for o in o2], [qb + o for o in o1],
                [Z if o < 0 else qb + o for o in o2])
    _combine_g2(s, C["C1"], 6, C["L1"], T["C1_TERMS"], None)
    _product_g2(s, C["L2"], 2, [C["B3"]] * 32, [Z] * 32,
                [C["C1"] + 10 if (lane >> 2) & 1 else C["C1"] + 4
                 for lane in range(32)], [Z] * 32)
    _combine_g2(s, C["C2"], 3, C["L2"], T["C2_TERMS"], T["C2_KEEP"])
    _product_g2(s, C["L3"], 6, [T["L3_OPS"][i][0] for i in j], [Z] * 32,
                [T["L3_OPS"][i][1] for i in j], [Z] * 32)
    _combine_g2(s, P, 3, C["L3"], T["C3_TERMS"], None)


# -- G1: one Fq product a lane, 3b = 9 inside the first combine ---------------


def _product_g1(s, out, ops):
    """hw1::product for all 32 lanes; ops(lane) -> (a1, a2, b1, b2)."""
    res = {}
    for lane in range(32):
        a1, a2, b1, b2 = ops(lane)
        r = (s[a1] + s[a2]) % Q * ((s[b1] + s[b2]) % Q) % Q
        if lane < 6:
            res[out + lane] = r
    s.update(res)


def _term_g1(s, L, r, e):
    k = s[L + abs(e) - 1 if e else HW["g1"].c["ZERO"]]
    return (r - k if e < 0 else r + k) % Q


def _combine_g1(s, out, nv, L, terms, nine, post):
    res = {}
    for lane in range(32):
        v = min(lane, nv - 1)
        r = s[HW["g1"].c["ZERO"]]
        for e in terms[v]:
            r = _term_g1(s, L, r, e)
        if nine and nine[v]:
            r8 = (r + r) % Q
            r8 = (r8 + r8) % Q
            r8 = (r8 + r8) % Q
            r = (r8 + r) % Q
        if post:
            r = _term_g1(s, L, r, post[v])
        if lane < nv:
            res[out + lane] = r
    s.update(res)


def _point_add_g1(s, qb):
    """hw1::point_add: acc (slots P) += the point at slots qb."""
    C, T = HW["g1"].c, HW["g1"].t
    P, Z = C["P"], C["ZERO"]

    def l1(lane):
        o1, o2 = T["L1_OPS"][min(lane, 5)]
        return (P + o1, Z if o2 < 0 else P + o2, qb + o1,
                Z if o2 < 0 else qb + o2)

    def l3(lane):
        a, b = T["L3_OPS"][min(lane, 5)]
        return a, Z, b, Z

    _product_g1(s, C["L1"], l1)
    _combine_g1(s, C["C1"], 6, C["L1"], T["C1_TERMS"], T["C1_NINE"],
                T["C1_POST"])
    _product_g1(s, C["L3"], l3)
    _combine_g1(s, P, 3, C["L3"], T["C3_TERMS"], None, None)


# -- both groups: points as Fq2 triples (G1 in c0, c1 = 0) ----------------------

GROUP = {
    "g1": dict(add=_point_add_g1, b3=Fq2(9, 0), width=1,
               layout=(["ZERO", "P", "Q", "L1", "C1", "L3", "SLOTS"],
                       [1, 3, 3, 6, 6, 6])),
    "g2": dict(add=_point_add_g2, b3=B2 * Fq2(3, 0), width=2,
               layout=(["ZERO", "P", "Q", "B3", "L1", "C1", "L2", "C2",
                        "L3", "SLOTS"], [2, 6, 6, 2, 24, 12, 8, 6, 24])),
}


def _flat(pt, g):
    """A point's coordinates as the slot values of one group."""
    if GROUP[g]["width"] == 1:
        return [f.c0 % Q for f in pt]
    return [c for f in pt for c in (f.c0 % Q, f.c1 % Q)]


def _read(s, at, g):
    if GROUP[g]["width"] == 1:
        return tuple(Fq2(s[at + i], 0) for i in range(3))
    return tuple(Fq2(s[at + 2 * i], s[at + 2 * i + 1]) for i in range(3))


def _scratch(acc, g):
    C = HW[g].c
    s = {i: 0 for i in range(C["SLOTS"])}
    for i, v in enumerate(_flat(acc, g)):
        s[C["P"] + i] = v
    if g == "g2":
        b3 = GROUP[g]["b3"]
        s[C["B3"]], s[C["B3"] + 1] = b3.c0, b3.c1
    return s


def _put(s, at, pt, g):
    for i, v in enumerate(_flat(pt, g)):
        s[at + i] = v


def rcb_add(p1, p2, b3):
    """curve.cuh point_add (RCB algorithm 7, a = 0), in order."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    t0, t1, t2 = x1 * x2, y1 * y2, z1 * z2
    t3 = (x1 + y1) * (x2 + y2) - (t0 + t1)
    t4 = (y1 + z1) * (y2 + z2) - (t1 + t2)
    y3 = (x1 + z1) * (x2 + z2) - (t0 + t2)
    t0 = t0 + t0 + t0
    t2 = b3 * t2
    z3, t1 = t1 + t2, t1 - t2
    y3 = b3 * y3
    return (t3 * t1 - t4 * y3, t1 * z3 + y3 * t0, z3 * t4 + t0 * t3)


def _affine(rng, g):
    """A random affine point of the group, coordinates as Fq2."""
    if g == "g1":
        x, y = g1_mul(G1_GEN, rng.randrange(1, R))
        return Fq2(x, 0), Fq2(y, 0)
    return g2_mul(G2_GEN, rng.randrange(1, R))


def _rand_point(rng, g):
    x, y = _affine(rng, g)
    z = (Fq2(rng.randrange(1, Q), 0) if g == "g1" else
         Fq2(rng.randrange(1, Q), rng.randrange(Q)))
    return (x * z, y * z, z)


def _host(g, p):
    """Affine Fq2 coordinates -> the host curve's point of group g."""
    return p if g == "g2" else tuple(c.c0 for c in p)


@pytest.mark.parametrize("g", ["g1", "g2"])
def test_layout_is_disjoint_and_in_order(g):
    order, sizes = GROUP[g]["layout"]
    C = HW[g].c
    assert set(C) == set(order)
    for a, b, n in zip(order, order[1:], sizes):
        assert C[b] - C[a] == n, (a, b)


@pytest.mark.parametrize("double", [False, True], ids=["add", "double"])
@pytest.mark.parametrize("g", ["g1", "g2"])
def test_warp_add_equals_rcb(g, double):
    rng = random.Random(11)
    P, Qs = HW[g].c["P"], HW[g].c["Q"]
    for _ in range(4):
        p1 = _rand_point(rng, g)
        p2 = p1 if double else _rand_point(rng, g)
        s = _scratch(p1, g)
        _put(s, Qs, p2, g)
        GROUP[g]["add"](s, P if double else Qs)
        assert _flat(_read(s, P, g), g) == _flat(
            rcb_add(p1, p2, GROUP[g]["b3"]), g)


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("g", ["g1", "g2"])
def test_warp_horner_equals_the_window_combine(g, bits):
    """acc = 2^bits acc + S_w over W windows, MSB first, from (0 : 1 : 0),
    with identities in the first and the last window."""
    rng = random.Random(bits)
    W = 5
    ident = (Fq2(0, 0), Fq2(1, 0), Fq2(0, 0))
    sums = [ident] + [_rand_point(rng, g) for _ in range(W - 2)] + [ident]
    P, Qs = HW[g].c["P"], HW[g].c["Q"]
    add = GROUP[g]["add"]
    s = _scratch(ident, g)
    for w in range(W - 1, -1, -1):
        for _ in range(bits):
            add(s, P)
        _put(s, Qs, sums[w], g)
        add(s, Qs)
    X, Y, Z = _read(s, P, g)
    host_add, host_mul = (g1_add, g1_mul) if g == "g1" else (g2_add, g2_mul)
    want = None
    for w, (x, y, z) in enumerate(sums):
        if z.is_zero():
            continue
        zi = z.inv()
        want = host_add(want, host_mul(_host(g, (x * zi, y * zi)),
                                       1 << (bits * w)))
    zi = Z.inv()
    assert _host(g, (X * zi, Y * zi)) == want
