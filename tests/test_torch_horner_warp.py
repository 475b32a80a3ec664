"""The warp schedule of csrc/ec.cu's G2 Horner (namespace hw): its slot
layout and stage tables, parsed from the source and run lane by lane in
Python, give the coordinates of RCB algorithm 7 (curve.cuh point_add)
and the window combine of the host curve."""

import random
import re
from pathlib import Path

import pytest

from za_tpu_torch.curve import B2, G2_GEN, Q, R, Fq2, g2_add, g2_mul

SRC = (Path(__file__).resolve().parent.parent / "za_tpu_torch" / "csrc"
       / "ec.cu").read_text()
HW = SRC[SRC.index("namespace hw {"):SRC.index("}  // namespace hw")]


def _consts() -> dict[str, int]:
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", HW)}


def _table(name: str):
    body = re.search(r"const int8_t " + name + r"\[[^=]*= (\{.*?\});", HW,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body).replace("{", "[").replace("}", "]")
    return eval(body, {}, _consts())  # noqa: S307 - the repo's own source


C = _consts()
TABLES = {n: _table(n) for n in ("L1_OPS", "L3_OPS", "C1_TERMS",
                                 "C2_TERMS", "C2_KEEP", "C3_TERMS")}


def _product(s, out, np, a1, a2, b1, b2):
    """hw::product for all 32 lanes: a1..b2 are per-lane slot lists."""
    res = {}
    for lane in range(32):
        q = lane & 3
        ca, cb = q & 1, (q ^ (q >> 1)) & 1
        a = (s[a1[lane] + ca] + s[a2[lane] + ca]) % Q
        b = (s[b1[lane] + cb] + s[b2[lane] + cb]) % Q
        if lane < 4 * np:
            res[out + lane] = a * b % Q
    s.update(res)


def _combine(s, out, nv, L, terms, keep):
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


def point_add(s, qb):
    """hw::point_add: acc (slots P) += the point at slots qb."""
    T, P, Z = TABLES, C["P"], C["ZERO"]
    j = [min(lane >> 2, 5) for lane in range(32)]
    o1 = [T["L1_OPS"][i][0] for i in j]
    o2 = [T["L1_OPS"][i][1] for i in j]
    _product(s, C["L1"], 6, [P + o for o in o1],
             [Z if o < 0 else P + o for o in o2], [qb + o for o in o1],
             [Z if o < 0 else qb + o for o in o2])
    _combine(s, C["C1"], 6, C["L1"], T["C1_TERMS"], None)
    _product(s, C["L2"], 2, [C["B3"]] * 32, [Z] * 32,
             [C["C1"] + 10 if (lane >> 2) & 1 else C["C1"] + 4
              for lane in range(32)], [Z] * 32)
    _combine(s, C["C2"], 3, C["L2"], T["C2_TERMS"], T["C2_KEEP"])
    _product(s, C["L3"], 6, [T["L3_OPS"][i][0] for i in j], [Z] * 32,
             [T["L3_OPS"][i][1] for i in j], [Z] * 32)
    _combine(s, P, 3, C["L3"], T["C3_TERMS"], None)


def _scratch(acc, b3):
    s = {i: 0 for i in range(C["SLOTS"])}
    for i, v in enumerate(_flat(acc)):
        s[C["P"] + i] = v
    s[C["B3"]], s[C["B3"] + 1] = b3.c0, b3.c1
    return s


def _flat(pt):
    return [c for f in pt for c in (f.c0 % Q, f.c1 % Q)]


def _read(s, at):
    return tuple(Fq2(s[at + 2 * i], s[at + 2 * i + 1]) for i in range(3))


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


def _rand_point(rng):
    p = g2_mul(G2_GEN, rng.randrange(1, R))
    z = Fq2(rng.randrange(1, Q), rng.randrange(Q))
    return (p[0] * z, p[1] * z, z)


def _same(a, b):
    return _flat(a) == _flat(b)


def test_layout_is_disjoint_and_in_order():
    order = ["ZERO", "P", "Q", "B3", "L1", "C1", "L2", "C2", "L3", "SLOTS"]
    sizes = [2, 6, 6, 2, 24, 12, 8, 6, 24]
    for a, b, n in zip(order, order[1:], sizes):
        assert C[b] - C[a] == n, (a, b)


@pytest.mark.parametrize("double", [False, True], ids=["add", "double"])
def test_warp_add_equals_rcb(double):
    rng = random.Random(11)
    b3 = B2 * Fq2(3, 0)
    for _ in range(4):
        p1 = _rand_point(rng)
        p2 = p1 if double else _rand_point(rng)
        s = _scratch(p1, b3)
        for i, v in enumerate(_flat(p2)):
            s[C["Q"] + i] = v
        point_add(s, C["P"] if double else C["Q"])
        assert _same(_read(s, C["P"]), rcb_add(p1, p2, b3))


@pytest.mark.parametrize("bits", [4, 2])
def test_warp_horner_equals_the_window_combine(bits):
    """acc = 2^bits acc + S_w over W windows, MSB first, from (0 : 1 : 0),
    with identities in the first and the last window."""
    rng = random.Random(bits)
    W = 5
    ident = (Fq2(0, 0), Fq2(1, 0), Fq2(0, 0))
    sums = [ident] + [_rand_point(rng) for _ in range(W - 2)] + [ident]
    b3 = B2 * Fq2(3, 0)
    s = _scratch(ident, b3)
    for w in range(W - 1, -1, -1):
        for _ in range(bits):
            point_add(s, C["P"])
        for i, v in enumerate(_flat(sums[w])):
            s[C["Q"] + i] = v
        point_add(s, C["Q"])
    X, Y, Z = _read(s, C["P"])
    want = None
    for w, (x, y, z) in enumerate(sums):
        if z.is_zero():
            continue
        zi = z.inv()
        want = g2_add(want, g2_mul((x * zi, y * zi), 1 << (bits * w)))
    zi = Z.inv()
    assert (X * zi, Y * zi) == want
