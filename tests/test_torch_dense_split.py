"""The dense window sums with segments (engine.msm_dense: S segments a
lane, L lanes from the card): whole MSMs on the CPU with S > 1 against
za_tpu's host arithmetic, zero tolerance (the per-lane sums against the
reference's are test_torch_dense.py's, beside its JAX compile);
lanes() against its rule at the H100's 132 SMs; the G1 product by 3b = 9
as additions (csrc/curve.cuh mul_b3) against the plain point_add's field
value; and a Python model of csrc/dense.cu's kernel, its index
arithmetic and loop heads parsed from the source: every point of a lane
is added exactly once, each lane's S segments fold into it, and every
accumulator is stored once at its (m, w, l)."""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from za_tpu.curve import (
    G1_GEN as ZG1, G2_GEN as ZG2, g1_add as z_g1_add, g1_mul as z_g1_mul,
    g2_add as z_g2_add, g2_mul as z_g2_mul,
)
from za_tpu_torch.curve import Q, R, Fq2
from za_tpu_torch.engine import ec, field as F, msm as MSM, msm_dense as MD
from za_tpu_torch.engine.engine import GpuEngine

SRC = (Path(__file__).resolve().parent.parent / "za_tpu_torch" / "csrc"
       / "dense.cu").read_text()
H100_SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_g2(p):
    return None if p is None else (Fq2(p[0].c0, p[0].c1),
                                   Fq2(p[1].c0, p[1].c1))


@pytest.mark.parametrize("style", [None, "fused"], ids=["radix16", "radix4"])
@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_segmented_msm_matches_host(is_g2, style, monkeypatch):
    """Whole MSMs through GpuEngine on the CPU with the lane fold held to
    2 lanes, so msm_dense runs S > 1 segments at n = 21: against za_tpu's
    host arithmetic, an identity point and the scalars 0, 1, r - 1."""
    monkeypatch.setitem(MD.FOLD_LANES, is_g2, 2)
    rng = random.Random(95 + 2 * is_g2 + (style is None))
    n = 21
    mul, add, gen = ((z_g2_mul, z_g2_add, ZG2) if is_g2
                     else (z_g1_mul, z_g1_add, ZG1))
    pts = [mul(gen, rng.randrange(1, R)) for _ in range(n)]
    pts[7] = None
    scs = [rng.randrange(R) for _ in range(n)]
    scs[:3] = [0, 1, R - 1]
    want = None
    for p, s in zip(pts, scs):
        if p is not None and s:
            want = add(want, mul(p, s))
    eng = GpuEngine(device="cpu", msm_style=style)
    assert MD.lanes(1, n, eng.radix, is_g2, MD.CPU_SLOTS[is_g2]) == (2, 8)
    if is_g2:
        assert eng.msm_g2([_port_g2(p) for p in pts], scs) == _port_g2(want)
    else:
        assert eng.msm_g1(pts, scs) == want


@pytest.mark.parametrize("blocks", [1, 2, 3, 4, 5, 8])
def test_lanes_rule(blocks):
    """(L, S) for 132 SMs holding `blocks` blocks each: powers of two,
    L <= FOLD_MAX_LANES and FOLD_LANES, S <= DTB, S L <= n, M W S L
    within WAVES x the card's threads, and S L the largest such."""
    slots = H100_SMS * blocks
    for M, n, radix, g2 in [(4, 1 << 14, 16, False), (1, 1 << 14, 16, True),
                            (4, 1 << 14, 4, False), (1, 1 << 14, 4, True),
                            (4, 1024, 16, False), (1, 1024, 16, True),
                            (3, 300, 16, False), (1, 13, 16, True),
                            (1, 1, 4, False)]:
        W = MSM.WINDOWS[MD.BITS[radix]]
        L, S = MD.lanes(M, n, radix, g2, slots)
        P = L * S
        cap = MD.WAVES[g2] * slots * MD.DTB
        assert L & (L - 1) == 0 and S & (S - 1) == 0
        assert L == min(P, MD.FOLD_LANES[g2]) <= MSM.FOLD_MAX_LANES
        assert 1 <= S <= MD.DTB and P <= n
        assert P == 1 or M * W * P <= cap
        assert 2 * P > n or M * W * 2 * P > cap


def _nine_by_adds(fld, x):
    """curve.cuh mul_b3 on Fq: 8 x + x by three doublings and an add"""
    r = fld.add(x, x)
    r = fld.add(r, r)
    r = fld.add(r, r)
    return fld.add(r, x)


def test_times_nine_by_additions():
    """G1's 3b = 9 by additions equals the plain point_add's Montgomery
    product by 9 R mod q on canonical values, the edges 0, 1, q - 1
    included; and an RCB add with it (the kernels' point_add) equals
    ec.point_add's coordinates on random (not only curve) points."""
    rng = np.random.default_rng(9)
    vals = [0, 1, Q - 1, Q - 9, (Q - 1) // 9, (Q + 8) // 9] + [
        int.from_bytes(rng.bytes(32), "little") % Q for _ in range(58)]
    fld = F.FQ
    x = torch.from_numpy(F.ints_to_limbs(vals).astype(np.int64))
    nine = fld.const(fld.to_mont_int(9), x)
    assert torch.equal(_nine_by_adds(fld, x), fld.mul(x, nine))

    def model(p, q):   # curve.cuh point_add with mul_b3
        x1, y1, z1 = p
        x2, y2, z2 = q
        t0, t1, t2 = fld.mul(x1, x2), fld.mul(y1, y2), fld.mul(z1, z2)
        t3 = fld.sub(fld.mul(fld.add(x1, y1), fld.add(x2, y2)),
                     fld.add(t0, t1))
        t4 = fld.sub(fld.mul(fld.add(y1, z1), fld.add(y2, z2)),
                     fld.add(t1, t2))
        y3 = fld.sub(fld.mul(fld.add(x1, z1), fld.add(x2, z2)),
                     fld.add(t0, t2))
        t0 = fld.add(fld.add(t0, t0), t0)
        t2 = _nine_by_adds(fld, t2)
        z3, t1 = fld.add(t1, t2), fld.sub(t1, t2)
        y3 = _nine_by_adds(fld, y3)
        return (fld.sub(fld.mul(t3, t1), fld.mul(t4, y3)),
                fld.add(fld.mul(t1, z3), fld.mul(y3, t0)),
                fld.add(fld.mul(z3, t4), fld.mul(t0, t3)))

    coords = [torch.from_numpy(F.ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(64)])
        .astype(np.int64)) for _ in range(6)]
    p, q = tuple(coords[:3]), tuple(coords[3:])
    got = model(p, q)
    want = ec.point_add(p, q, fld)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- a model of csrc/dense.cu's kernel ---------------------------------------


def _kernel_body():
    start = SRC.index("dense_sums_kernel(")
    return SRC[start:SRC.index("\ntemplate", start)]


def _py(expr: str) -> str:
    """A C integer expression of the kernel -> Python (non-negative
    operands: / and % are floor division and remainder)."""
    expr = re.sub(r"\((?:size_t|int)\)", "", expr)
    expr = expr.replace("threadIdx.x", "tid").replace("blockIdx.x", "bid")
    expr = expr.replace("&&", " and ").replace("||", " or ")
    return re.sub(r"(?<![/])/(?![/])", "//", expr)


def _decls(body: str, names):
    """The kernel's declarations of the given names, in source order:
    [(name, Python expression)]."""
    out = []
    for stmt in re.findall(r"const (?:int|size_t|bool) ([^;]+);", body):
        for part in re.split(r",\s*(?=\w+ = )", stmt):
            name, expr = part.split(" = ", 1)
            if name.strip() in names:
                out.append((name.strip(), _py(expr)))
    return out


def _model(M, W, n, L, S):
    """Run the kernel's index arithmetic and loops, each add as a union
    of point sets -> {output index: points}, {output index: digit row}."""
    body = _kernel_body()
    DTB = int(re.search(r"constexpr int DTB = (\d+);", SRC).group(1))
    grid = re.search(r"<<<\(unsigned\)\(([^,]+)\),\s*DTB", SRC).group(1)
    decls = _decls(body, {"per", "j", "s", "total", "a", "live", "l", "r",
                          "w", "m", "self", "t"})
    walk = re.search(r"for \(int i = ([^;]+); i < n; i \+= ([^)]+)\)", body)
    gate = re.search(r"if \((S > 1)\) \{", body).group(1)
    fold = re.search(r"for \(int h = ([^;]+); h > 0; h >>= 1\) \{\s*"
                     r"if \(([^)]+)\) fold_add<F, O>\(part, ([^,]+), "
                     r"([^)]+)\);", body)
    final = re.search(r"if \((live && s == 0)\) \{", body).group(1)
    assert walk and fold
    env = {"M": M, "W": W, "n": n, "L": L, "S": S, "DTB": DTB}
    blocks = eval(_py(grid), {}, {**env, "total": M * W * L,
                                  "per": DTB // S})
    out, rows = {}, {}
    for bid in range(blocks):
        th = []
        for tid in range(DTB):
            v = {**env, "bid": bid, "tid": tid}
            for name, expr in decls:
                v[name] = eval(expr, {}, v)
            pts = []
            if v["live"]:
                i = eval(_py(walk.group(1)), {}, v)
                while i < n:
                    pts.append(i)
                    i += eval(_py(walk.group(2)), {}, v)
            v["acc"] = pts
            th.append(v)
        if eval(_py(gate), {}, env):
            part = {v["self"]: v["acc"] for v in th}  # shared memory
            assert sorted(part) == list(range(DTB))
            h = eval(_py(fold.group(1)), {}, th[0])
            while h > 0:
                adds = [(eval(_py(fold.group(3)), {}, {**v, "h": h}),
                         eval(_py(fold.group(4)), {}, {**v, "h": h}))
                        for v in th
                        if eval(_py(fold.group(2)), {}, {**v, "h": h})]
                dst = [a for a, _ in adds]
                src = [b for _, b in adds]
                assert len(set(dst)) == len(dst) and not set(dst) & set(src)
                new = {a: part[a] + part[b] for a, b in adds}
                part.update(new)
                h >>= 1
            for v in th:
                v["acc"] = part[v["self"]]
        for v in th:
            if eval(_py(final), {}, v):
                assert v["t"] not in out
                out[v["t"]], rows[v["t"]] = v["acc"], v["r"]
    return out, rows


@pytest.mark.parametrize("M,W,n,L,S", [
    (2, 3, 37, 4, 4), (1, 2, 300, 8, 16), (3, 2, 64, 64, 2),
    (1, 1, 5, 2, 128), (4, 2, 1000, 128, 1), (1, 3, 70, 1, 32)])
def test_kernel_model_adds_each_point_once(M, W, n, L, S):
    """Every (m, w, l) is stored once; its sum holds each point i = l
    mod L below n exactly once, read from digit row w M + m."""
    out, rows = _model(M, W, n, L, S)
    assert sorted(out) == list(range(M * W * L))
    for t, pts in out.items():
        m, w, lane = t // (W * L), t // L % W, t % L
        assert sorted(pts) == list(range(lane, n, L))
        assert rows[t] == w * M + m
