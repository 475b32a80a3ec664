"""The kernels' field inversion (csrc/field.cuh inv_gcd): a step-for-step
model in Python, held against Fermat's a^(q-2) mod q; and the Fq2
inversion through the norm (Gcd for Fq2, block_inverse_gcd), modelled on
it and held against the host Fq2 inverse.

The model keeps the kernel's arithmetic: nine signed 30-bit limbs in
int32 words, int64 sums (checked for overflow), 32-bit wrap-around in
the divsteps, 20 batches of 30 divsteps, and the final Montgomery
product with R^3 mod q that turns the inverse of aR into a^-1 R.  The
constants it reads (q, -q^-1 mod 2^32, R^3 mod q) are parsed from the
header, so a wrong constant there fails here."""

import random
import re
from pathlib import Path

import pytest

from za_tpu.curve import Fq2, Q

HEADER = (Path(__file__).resolve().parent.parent / "za_tpu_torch" / "csrc"
          / "field.cuh").read_text()
R = 1 << 256
M30 = (1 << 30) - 1
U32 = (1 << 32) - 1
BATCHES, STEPS = 20, 30


def _qparams_words(name: str) -> int:
    body = HEADER[HEADER.index("struct QParams"):HEADER.index("struct RParams")]
    m = re.search(r"\b" + name + r"\(int i\).*?constexpr uint32_t v\[8\] = "
                  r"\{([^}]*)\}", body, re.S)
    words = [int(w.strip().rstrip("u"), 16) for w in m.group(1).split(",")]
    return sum(w << (32 * i) for i, w in enumerate(words))


def _np0() -> int:
    body = HEADER[HEADER.index("struct QParams"):HEADER.index("struct RParams")]
    return int(re.search(r"np0 = (0x[0-9a-f]+)u", body).group(1), 16)


def i32(x: int) -> int:
    x &= U32
    return x - (1 << 32) if x >> 31 else x


def i64(x: int) -> int:
    assert -(1 << 63) <= x < (1 << 63), "int64 overflow"
    return x


def to_s30(w: list[int]) -> list[int]:
    out = []
    for i in range(9):
        word, sh = 30 * i // 32, 30 * i % 32
        lo = w[word] >> sh
        if sh > 2 and word < 7:
            lo |= (w[word + 1] << (32 - sh)) & U32
        out.append(lo & M30)
    return out


def from_s30(a: list[int]) -> list[int]:
    w = []
    for j in range(8):
        i, sh = 32 * j // 30, 32 * j % 30
        w.append(((a[i] & U32) >> sh | (a[i + 1] << (30 - sh))) & U32)
    return w


def divsteps_30(zeta, f, g):
    u, v, q, r = 1, 0, 0, 1
    for _ in range(STEPS):
        c1 = (zeta >> 31) & U32
        c2 = (-(g & 1)) & U32
        x, y, z = ((f ^ c1) - c1) & U32, ((u ^ c1) - c1) & U32, \
            ((v ^ c1) - c1) & U32
        g = (g + (x & c2)) & U32
        q = (q + (y & c2)) & U32
        r = (r + (z & c2)) & U32
        c1 &= c2
        zeta = i32((zeta ^ i32(c1)) - 1)
        f = (f + (g & c1)) & U32
        u = (u + (q & c1)) & U32
        v = (v + (r & c1)) & U32
        g >>= 1
        u = (u << 1) & U32
        v = (v << 1) & U32
    return zeta, (i32(u), i32(v), i32(q), i32(r))


def update_fg_30(f, g, t):
    u, v, q, r = t
    cf = i64(u * f[0] + v * g[0])
    cg = i64(q * f[0] + r * g[0])
    assert cf & M30 == 0 and cg & M30 == 0
    cf >>= 30
    cg >>= 30
    for i in range(1, 9):
        cf = i64(cf + i64(u * f[i] + v * g[i]))
        cg = i64(cg + i64(q * f[i] + r * g[i]))
        f[i - 1], g[i - 1] = cf & M30, cg & M30
        cf >>= 30
        cg >>= 30
    f[8], g[8] = i32(cf), i32(cg)
    assert f[8] == cf and g[8] == cg


def update_de_30(d, e, t, p, pinv):
    u, v, q, r = t
    sd, se = d[8] >> 31, e[8] >> 31
    md = i32((u & sd) + (v & se))
    me = i32((q & sd) + (r & se))
    cd = i64(u * d[0] + v * e[0])
    ce = i64(q * d[0] + r * e[0])
    md = i32(md - ((pinv * (cd & U32) + (md & U32)) & M30))
    me = i32(me - ((pinv * (ce & U32) + (me & U32)) & M30))
    cd = i64(cd + p[0] * md)
    ce = i64(ce + p[0] * me)
    assert cd & M30 == 0 and ce & M30 == 0
    cd >>= 30
    ce >>= 30
    for i in range(1, 9):
        cd = i64(cd + i64(u * d[i] + v * e[i]) + p[i] * md)
        ce = i64(ce + i64(q * d[i] + r * e[i]) + p[i] * me)
        d[i - 1], e[i - 1] = cd & M30, ce & M30
        cd >>= 30
        ce >>= 30
    d[8], e[8] = i32(cd), i32(ce)
    assert d[8] == cd and e[8] == ce


def normalize_30(a, sign, p):
    add = a[8] >> 31
    a[:] = [x + (pi & add) for x, pi in zip(a, p)]
    ng = sign >> 31
    a[:] = [(x ^ ng) - ng for x in a]
    for i in range(8):
        a[i + 1] += a[i] >> 30
        a[i] &= M30
    add = a[8] >> 31
    a[:] = [x + (pi & add) for x, pi in zip(a, p)]
    for i in range(8):
        a[i + 1] += a[i] >> 30
        a[i] &= M30
    assert all(-(1 << 31) <= x < (1 << 31) for x in a)


def value(a: list[int]) -> int:
    return sum(x << (30 * i) for i, x in enumerate(a))


def words(x: int) -> list[int]:
    return [(x >> (32 * i)) & U32 for i in range(8)]


def inv_gcd(aR: int) -> int:
    """The kernel's inv_gcd on the Montgomery form aR -> a^-1 R mod q."""
    q = _qparams_words("p")
    pinv = (-_np0()) & M30
    p = to_s30(words(q))
    d, e, f, g = [0] * 9, [1] + [0] * 8, list(p), to_s30(words(aR))
    zeta = -1
    for _ in range(BATCHES):
        zeta, t = divsteps_30(zeta, f[0] & U32, g[0] & U32)
        update_de_30(d, e, t, p, pinv)
        update_fg_30(f, g, t)
        assert -(2 * q) < value(d) < q and -(2 * q) < value(e) < q
    assert value(g) == 0 and value(f) in (1, -1) or aR == 0
    normalize_30(d, f[8], p)
    x = sum(w << (32 * i) for i, w in enumerate(from_s30(d)))
    assert 0 <= x < q
    r3 = _qparams_words("r3")
    return x * r3 * pow(R, -1, q) % q  # mul(x, R^3 mod q)


def test_header_constants():
    assert _qparams_words("p") == Q
    assert _qparams_words("one") == R % Q
    assert _qparams_words("r3") == R ** 3 % Q
    assert (_np0() * Q + 1) % (1 << 32) == 0


def test_s30_round_trip():
    rng = random.Random(3)
    for x in [0, 1, Q - 1, (1 << 256) - 1] + [rng.getrandbits(256)
                                                  for _ in range(50)]:
        a = to_s30(words(x))
        assert value(a) == x and all(0 <= v <= M30 for v in a)
        assert sum(w << (32 * i) for i, w in enumerate(from_s30(a))) == x


def _check(a: int):
    assert inv_gcd(a * R % Q) == pow(a, Q - 2, Q) * R % Q


def test_inverse_of_a_seeded_batch():
    rng = random.Random(20261017)
    for _ in range(200):
        _check(rng.randrange(1, Q))


@pytest.mark.parametrize("a", [
    1, 2, Q - 1, Q - 2, R % Q, pow(R, -1, Q), (1 << 253) % Q,
    ((1 << 254) - 1) % Q, (1 << 253) - 1, Q >> 1, (Q + 1) // 2,
    (1 << 30) - 1, 1 << 30, 3 ** 160 % Q,
], ids=lambda a: hex(a)[:10])
def test_inverse_of_edge_values(a):
    _check(a)


def test_montgomery_forms_at_the_edges():
    """Inputs aR equal to 1, 2, q - 1 and values just under q and 2^253:
    canonical inputs the kernel can meet whatever a is."""
    for x in (1, 2, Q - 1, Q - 2, (1 << 253) - 1, 1 << 253, R % Q):
        a = x * pow(R, -1, Q) % Q
        assert inv_gcd(x) == pow(a, Q - 2, Q) * R % Q


def test_zero_maps_to_zero():
    assert inv_gcd(0) == 0


# -- Fq2 through the norm ----------------------------------------------------

RINV = pow(R, -1, Q)
ONE_M = R % Q   # the field's one in Montgomery form


def mont(a: int, b: int) -> int:
    """The kernels' mul: a b R^-1 mod q on Montgomery forms."""
    return a * b * RINV % Q


def norm_m(a):
    """norm(a) = a0^2 + a1^2 on Montgomery forms (two sqr, one add)."""
    return (mont(a[0], a[0]) + mont(a[1], a[1])) % Q


def conj_scale(a, s):
    return mont(a[0], s), (-mont(a[1], s)) % Q


def to_m(c0: int, c1: int):
    return c0 * R % Q, c1 * R % Q


def _host_inverse_m(c0: int, c1: int):
    h = Fq2(c0, c1).inv()
    assert Fq2(c0, c1) * h == Fq2.one()
    return to_m(h.c0, h.c1)


def _check_fq2(c0: int, c1: int):
    a = to_m(c0, c1)
    assert conj_scale(a, inv_gcd(norm_m(a))) == _host_inverse_m(c0, c1)


def test_fq2_inverse_of_a_seeded_batch():
    rng = random.Random(20261018)
    for _ in range(60):
        _check_fq2(rng.randrange(Q), rng.randrange(1, Q))


@pytest.mark.parametrize("c0,c1", [
    (5, 0), (Q - 1, 0), (0, 5), (0, Q - 1), (1, 0), (0, 1), (Q - 1, Q - 1),
    (1, Q - 1), (Q - 1, 1), (1, 1), (RINV, 0), (0, RINV),
], ids=["c1=0", "c1=0,c0=q-1", "c0=0", "c0=0,c1=q-1", "one", "i", "q-1,q-1",
        "1,q-1", "q-1,1", "1+i", "mont-one", "mont-i"])
def test_fq2_inverse_of_edge_values(c0, c1):
    _check_fq2(c0, c1)


def block_inverse_fq2(accs):
    """block_inverse_gcd<TB> on Fq2, thread by thread: the norms go
    into a product tree over 2 TB slots, inv_gcd inverts the root, the
    tree is unwound (inv(left) = inv(parent) * right) and each thread
    returns conj(acc) N(acc)^-1."""
    tb = len(accs)
    tree = [0] * (2 * tb)
    for t, a in enumerate(accs):
        tree[tb + t] = norm_m(a)
    s = tb // 2
    while s >= 1:
        for t in range(s):
            tree[s + t] = mont(tree[2 * (s + t)], tree[2 * (s + t) + 1])
        s //= 2
    tree[1] = inv_gcd(tree[1])
    s = 1
    while s < tb:
        for t in range(s):
            nd = s + t
            iv, lft, rgt = tree[nd], tree[2 * nd], tree[2 * nd + 1]
            tree[2 * nd], tree[2 * nd + 1] = mont(iv, rgt), mont(iv, lft)
        s *= 2
    return [conj_scale(a, tree[tb + t]) for t, a in enumerate(accs)]


@pytest.mark.parametrize("seed", [1, 2])
def test_norm_tree_block_inversion(seed):
    """128 thread values, some the field's one (a thread with no live
    pair), some with a zero component, some with q - 1 components: each
    gets its exact inverse."""
    rng = random.Random(seed)
    vals = []
    for t in range(128):
        kind = t % 8
        if kind == 0:
            vals.append((1, 0))
        elif kind == 1:
            vals.append((0, rng.randrange(1, Q)))
        elif kind == 2:
            vals.append((rng.randrange(1, Q), 0))
        elif kind == 3:
            vals.append((Q - 1, rng.choice([0, 1, Q - 1])))
        else:
            vals.append((rng.randrange(Q), rng.randrange(1, Q)))
    rng.shuffle(vals)
    got = block_inverse_fq2([to_m(*v) for v in vals])
    assert got == [_host_inverse_m(*v) for v in vals]
    assert got[vals.index((1, 0))] == (ONE_M, 0)
