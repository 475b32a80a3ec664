"""The MSM tail of the port: the lane fold (engine.msm.lane_fold) and the
tree's chunk carry (engine.cuda_tree.chunk_carry), plain versions on the
CPU, against the reference's msm.lane_fold (recursive doubling, not
fold-half) and its carry scan (msm_tree.tree_window_sums), and against
host arithmetic; points compared normalized.  Then a Python model of the
schedules of csrc/ec.cu's ec_sum_kernel (the fold and the carry), its
constants and loop heads parsed from the source: every level of a fold
pairs lane i with lane i + h for each i < h exactly once, whatever the
block's warps, the level from which adds run staged, the windows a
block, the blocks a window is split over and G2's unit width, so the
kernel's sum is the fold-half tree of the plain version; the carry's
units and lanes cover every partial and every word once; fold_plan and
carry_plan at the proofs' shapes.

The points are multiples k P of the generators by small numpy-seeded k
(G1 and G2 from the same k), so each window's expected sum is one short
host multiplication; reference compiles stay at 256 points or fewer."""

import functools
import importlib.util
import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import za_tpu.engine.ec as ZEC
import za_tpu.engine.msm as ZMSM
from za_tpu.curve import G1_GEN as ZG1, G2_GEN as ZG2
from za_tpu.curve import g1_mul as z_g1_mul, g2_mul as z_g2_mul
from za_tpu_torch.curve import G1_GEN, G2_GEN, R, Fq2, g1_mul, g2_mul
from za_tpu_torch.engine import cuda_tree as CT, ec, msm as MSM
from za_tpu_torch.engine import msm_tree as MT

SRC = (Path(__file__).resolve().parent.parent / "za_tpu_torch" / "csrc"
       / "ec.cu").read_text()
POOL = np.random.default_rng(2026).integers(1, 1 << 12, 13)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(g2):
    return (g2_mul, G2_GEN) if g2 else (g1_mul, G1_GEN)


def _port_g2(p):
    return None if p is None else (Fq2(p[0].c0, p[0].c1),
                                   Fq2(p[1].c0, p[1].c1))


def _pool(g2):
    """The pool's points and the identity last, projective l32 (8[, 2],
    P + 1)."""
    mul, gen = _host(g2)
    return ec.points_to_device([mul(gen, int(k)) for k in POOL] + [None],
                               g2)


def _lanes(seed, shape, ident=0.15):
    """Pool indices (P: the identity) of a random share of identity
    lanes, every lane of the first window of the first MSM too."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(POOL), shape)
    idx[rng.random(shape) < ident] = len(POOL)
    idx[(0,) * (len(shape) - 1)] = len(POOL)
    return idx


def _gather(pool, idx):
    t = torch.from_numpy(idx)
    return tuple(c[..., t] for c in pool)


def _normalized(pts, g2):
    """Projective (8[, 2], ...) -> host affine points (None: identity)."""
    ne = ec.elem_axes(g2)
    flat = [c.reshape(c.shape[:ne] + (-1,)) for c in pts]
    if g2:
        return ec.g2_points_from_device(*flat)
    return ec.g1_points_from_device(*flat)


def _expected(idx, axes, g2):
    """sum over the given axes of the lanes' points, as host points."""
    k = np.append(POOL, 0)[idx].astype(object).sum(axis=axes)
    mul, gen = _host(g2)
    return [None if t % R == 0 else mul(gen, int(t) % R)
            for t in np.ravel(k)]


@pytest.mark.parametrize("W", [64, 127])
@pytest.mark.parametrize("L", [1, 2, 8, 128])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_lane_fold_matches_host(g2, L, W):
    idx = _lanes(L * W, (1, W, L))
    got = MSM.lane_fold(_gather(_pool(g2), idx), g2)
    assert got[0].shape[ec.elem_axes(g2):] == (1, W)
    assert _normalized(got, g2) == _expected(idx, -1, g2)


def _ref_points(idx, g2):
    mul, gen = (z_g2_mul, ZG2) if g2 else (z_g1_mul, ZG1)
    pool = [mul(gen, int(k)) for k in POOL] + [None]
    return [pool[i] for i in np.ravel(idx)]


def _ref_ops(g2):
    return ZEC.make_g2_ops_rns() if g2 else ZEC.make_g1_ops_rns()


def _from_ref(R3, n, g2):
    conv = ZEC.g2_point_from_rns if g2 else ZEC.g1_point_from_rns
    out = [conv(*(np.asarray(c)[..., i:i + 1] for c in R3))
           for i in range(n)]
    return [_port_g2(p) for p in out] if g2 else out


@pytest.mark.parametrize("W,L", [(127, 2), (2, 128), (32, 8)])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_lane_fold_matches_reference(g2, W, L):
    """The same lanes through the reference's recursive-doubling fold
    (RNS) and the port's fold-half: the same points once normalized."""
    idx = _lanes(W + L, (W, L))
    to_rns = ZEC.g2_points_to_rns if g2 else ZEC.g1_points_to_rns
    acc = tuple(jnp.asarray(c).reshape(c.shape[:-1] + (W, L))
                for c in to_rns(_ref_points(idx, g2)))
    ref = _from_ref(ZMSM.lane_fold(acc, _ref_ops(g2), L), W, g2)
    got = _normalized(MSM.lane_fold(_gather(_pool(g2), idx[None]), g2), g2)
    assert got == ref == _expected(idx, -1, g2)


def _stacked(pool, idx):
    """Stacked flagged affine partials of idx (C, M, W, T): x, y (C, *E,
    M, W, T) of the pool's points, inf where idx picks the identity."""
    X, Y, _ = _gather(pool, idx)
    ne = X.dim() - idx.ndim
    return (X.movedim(ne, 0).contiguous(), Y.movedim(ne, 0).contiguous(),
            torch.from_numpy(idx == len(POOL)))


@functools.cache
def _ref_add(g2):
    ops = _ref_ops(g2)
    return jax.jit(lambda a, b: ZEC.point_add(a, b, ops))


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_chunk_carry_matches_reference_scan(g2, C):
    """C chunks' partials (M = 1, W = 16, T = 8), one chunk all at
    infinity and one lane at infinity in every chunk, through the port's
    carry (the plain fold-half over the chunks) and the reference's scan
    (the first chunk, then point_add(carry, chunk), as
    msm_tree.tree_window_sums runs it): the same points mod p, and the
    host sums.  One chunk: the partials as msm_tree.proj_of_affine has
    them, (x : y : 1) and (0 : 1 : 0) where flagged, bit for bit."""
    W, T = 16, 8
    idx = _lanes(7 + C, (C, 1, W, T), ident=0.3)
    idx[C // 2] = len(POOL)                # a chunk at infinity
    idx[:, 0, 5, 3] = len(POOL)            # a lane at infinity in each chunk
    pool = _pool(g2)
    x, y, inf = _stacked(pool, idx)
    got = CT.chunk_carry(x, y, inf, g2)
    assert got[0].shape == x.shape[1:]
    if C == 1:
        ne = ec.elem_axes(g2)
        want = MT.proj_of_affine(x[0], y[0], inf[0], g2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        zero, one, _ = ec.identity_like(x[0], g2)
        m = inf[0].view((1,) * ne + tuple(inf[0].shape))
        assert torch.equal(got[2], torch.where(m, zero, one))
    to_rns = ZEC.g2_points_to_rns if g2 else ZEC.g1_points_to_rns
    ref = None
    for c in range(C):
        part = to_rns(_ref_points(idx[c], g2))
        ref = part if ref is None else _ref_add(g2)(ref, part)
    assert (_normalized(got, g2) == _from_ref(ref, W * T, g2)
            == _expected(idx, 0, g2))


# -- the kernels' schedules, modelled from csrc/ec.cu ---------------------------


def _staged(group: str, width: int = 32) -> dict:
    """Staged<Fq, 6> / Staged<Fq2, width>'s constants."""
    head = "Staged<Fq, 6>" if group == "Fq" else "Staged<Fq2, W>"
    body = re.search(r"struct " + re.escape(head) + r" \{(.*?)\n\};", SRC,
                     re.S).group(1)
    if group == "Fq2":
        assert "NS = 6, UNITS = 32 / W, WIDTH = W;" in body
        return {"NS": 6, "UNITS": 32 // width, "WIDTH": width}
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


# the staged add's units: G1's, and G2's at each width ec.cu instantiates
WIDTHS = [pytest.param("Fq", 6, id="Fq"), pytest.param("Fq2", 32, id="Fq2"),
          pytest.param("Fq2", 16, id="Fq2-w16"),
          pytest.param("Fq2", 8, id="Fq2-w8")]


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _kernel(name: str) -> str:
    start = SRC.index(f"\n{name}(")
    return SRC[start:SRC.index("\n}\n", start)]


LEVEL_LINES = [  # the loops the model below runs, as fold_levels has them
    "for (int h = n >> 1; h >= stop; h >>= 1) {",
    "if (THREADS && h > wide) {",
    "for (int i = tid; i < h; i += nt) {",
    "if (i + h >= nv) continue;",
    "if (LEAVES && i + 2 * h >= nv) thread_add<F, 2>(pts, i, h);",
    "else if (LEAVES && i + 3 * h >= nv) thread_add<F, 1>(pts, i, h);",
    "else thread_add<F, 0>(pts, i, h);",
    "for (int b = warp * S::UNITS; b < h; b += units) {",
    "const int i = b + k;",
    "const bool on = i < h && i + h < nv;",
    "S::add(s, on ? pts + i * S::NS : s + S::P,",
    "on ? pts + (i + h) * S::NS : s + S::Q, sub);",
]
SUM_LINES = [  # ec_sum_kernel: B columns, lane c of column col at c B + col
    "const int n = C / K;",
    "const int nv = n * B, tid = threadIdx.x, nt = blockDim.x;",
    "const int k = min(lane / S::WIDTH, S::UNITS - 1);",
    "const int sub = lane - S::WIDTH * k;",
    "Fq* s = smem + max(n, K) * B * S::NS + (warp * S::UNITS + k) * S::SLOTS;",
    "const size_t j0 = (size_t)(blockIdx.x / K) * B;",
    "for (int e = tid; e < 8 * S::NS * nv; e += nt) {",
    "const int col = e % B, a = e / B, c = a % n;",
    "point_word<F>(a / n, cc, pl, slot, limb);",
    "pts[(c * B + col) * S::NS + slot].v[limb] = v;",
    "if (!THREADS || wide >= B) S::init(s, sub);",
    "fold_levels<F, W, THREADS, !FOLD>(pts, s, P * B, B, nv, wide, k, sub);",
    "for (int e = tid; e < 8 * S::NS * B; e += nt) {",
    "const int col = e % B;",
    "point_word<F>(e / B, c, pl, slot, limb);",
    "(c == 0 ? X : c == 1 ? Y : Z)[pl * (size_t)N + j0 + col] =",
    "pts[col * S::NS + slot].v[limb];",
]
FOLD_LINES = [  # FOLD: block r of K takes lanes r, r + K, ... of B windows
    "v = src[(pl * (size_t)N + j0 + col) * C + c * K + r];",
    "const Fq* far = cluster.map_shared_rank(smem, e / (S::NS * B) + 1);",
    "pts[S::NS * B + e] = far[e % (S::NS * B)];",
    "fold_levels<F, W, THREADS, false>(pts, s, K * B, B, K * B, wide, k,",
]
CARRY_LINES = [  # !FOLD: the chunks' flagged affine partials
    "const bool at_inf = zi[(size_t)c * N + j0 + col] != 0;",
    "if (cc == 2) v = at_inf ? 0u : one_w;",
    "else if (at_inf) v = cc == 1 ? one_w : 0u;",
    "else v = (cc == 0 ? x : y)[((size_t)c * 8 * per + pl) * N + j0 + col];",
]
ENTRY_LINES = [  # the fold and the carry of each group, one launcher
    "za::launch_sum<za::Fq, 6, true>(X, Y, Z, OX, OY, OZ, L, G, B, split,",
    "za::launch_sum<za::Fq2, za::FOLD_G2_WIDTH, true>(",
    "za::launch_sum<za::Fq, 6, false>(x, y, inf, X, Y, Z, C, N, B, 1,",
    "za::launch_sum<za::Fq2, za::CARRY_G2_WIDTH, false>(",
]


def test_fold_and_carry_source_matches_the_model():
    levels = SRC[SRC.index("void fold_levels("):]
    levels = levels[:levels.index("\n}\n")]
    for line in LEVEL_LINES:
        assert line in levels, line
    body = _kernel("ec_sum_kernel")
    for line in SUM_LINES + FOLD_LINES + CARRY_LINES:
        assert line in body, line
    for line in ENTRY_LINES:
        assert line in SRC, line
    assert _staged("Fq") == {"NS": 3, "UNITS": 5, "WIDTH": 6}
    assert _const("FOLD_MAX_LANES") == MSM.FOLD_MAX_LANES
    assert _const("FOLD_MAX_SPLIT") == MSM.FOLD_MAX_SPLIT
    assert _const("FOLD_MAX_THREADS") == 32 * MSM.FOLD_MAX_WARPS
    for g2, grp in ((False, "Fq"), (True, "Fq2")):
        fold, carry = ((_staged(grp, _const("FOLD_G2_WIDTH")),
                        _staged(grp, _const("CARRY_G2_WIDTH"))) if g2
                       else (_staged(grp),) * 2)
        slots = 90 if g2 else 25      # hw2::SLOTS, hw1::SLOTS
        assert re.search(rf"constexpr int SLOTS = {slots};",
                         SRC[SRC.index(f"namespace hw{2 if g2 else 1} {{"):])
        # the plans: a point's bytes, a warp's staged adds at once and
        # their scratch (the fold's, the carry's), a warp's thread adds
        assert MSM.POINT_BYTES[g2] == 32 * fold["NS"]
        assert MSM.STAGED_UNITS[g2] == fold["UNITS"]
        assert MSM.STAGED_SCRATCH[g2] == fold["UNITS"] * slots * 32
        assert CT.CARRY_PER_WARP[g2] == (carry["UNITS"] if g2
                                         else MSM.THREAD_ADDS)
        assert CT.CARRY_SCRATCH[g2] == (carry["UNITS"] * slots * 32 if g2
                                        else 0)
        assert CT.CARRY_STAGED_MAX[g2] == (1 << 30 if g2 else 0)
        assert MSM.FOLD_STAGED_MAX[g2] >= (1 << 30 if g2 else 0)
    assert MSM.THREAD_ADDS == 32 and MSM.SMEM == 232448


def test_ptxas_names_follow_the_kernel_templates():
    """chip_smoke.KERNEL_FN names the __global__ functions whose ptxas
    registers the fold and carry rows report, by the prefix of their
    mangled names: ec_sum_kernel <F, staged lanes, thread adds, fold>,
    the G1 fold with and without thread adds (a plan whose levels all
    run staged launches the latter), G2's on FOLD_G2_WIDTH lanes, the
    carry <Fq, 6, true, false> (CARRY_STAGED_MAX 0) and <Fq2,
    CARRY_G2_WIDTH, false, false>; G2 compiles no thread add."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    heads = re.findall(r"template <([^>]*)>\n__global__ void "
                       r"__launch_bounds__\(FOLD_MAX_THREADS\)\n(\w+)\(",
                       SRC)
    assert heads == [("class F, int W, bool THREADS, bool FOLD",
                      "ec_sum_kernel")]
    fq, fq2 = "NS_2FpINS_7QParamsEEE", "NS_3Fq2E"
    fw, cw = _const("FOLD_G2_WIDTH"), _const("CARRY_G2_WIDTH")
    pre = "_ZN2za13ec_sum_kernelI"
    assert CT.CARRY_STAGED_MAX == {False: 0, True: 1 << 30}
    assert {k: v for k, v in cs.KERNEL_FN.items()
            if k.startswith(("ec_fold", "ec_carry"))} == {
        "ec_fold_g1": f"{pre}{fq}Li6ELb1ELb1E",
        "ec_fold_g1.staged": f"{pre}{fq}Li6ELb0ELb1E",
        "ec_fold_g2": f"{pre}{fq2}Li{fw}ELb0ELb1E",
        "ec_carry_g1": f"{pre}{fq}Li6ELb1ELb0E",
        "ec_carry_g2": f"{pre}{fq2}Li{cw}ELb0ELb0E"}


def _levels(lanes, warps, wide, st, stop=1, nv=None, leaves=False):
    """fold_levels on one block's lanes (trees: nested pairs of input
    lane numbers; None past nv): each level's adds by worker, each i <
    h with a lane i + h once; a thread's add told that lane i + h (and
    lane i) is a leaf exactly where it is still an input lane -> the
    lanes left (stop of them)."""
    nt, units = 32 * warps, warps * st["UNITS"]
    nv = len(lanes) if nv is None else nv
    assert all(lanes[j] is None for j in range(nv, len(lanes)))
    h = len(lanes) >> 1
    while h >= stop:
        done = []
        if h > wide:
            for tid in range(nt):
                for i in range(tid, h, nt):
                    if i + h < nv:
                        done.append(i)
                        kind = (0 if not leaves else 2 if i + 2 * h >= nv
                                else 1 if i + 3 * h >= nv else 0)
                        want = (0 if not leaves
                                or isinstance(lanes[i + h], tuple) else
                                1 if isinstance(lanes[i], tuple) else 2)
                        assert kind == want, (len(lanes), nv, h, i)
        else:
            for lane in range(32):
                k = min(lane // st["WIDTH"], st["UNITS"] - 1)
                sub = lane - st["WIDTH"] * k
                if sub != 0:          # one record per unit (its lane 0)
                    continue
                for warp in range(warps):
                    for b in range(warp * st["UNITS"], h, units):
                        if b + k < h and b + k + h < nv:
                            done.append(b + k)
        want = [i for i in range(h) if i + h < nv]
        assert sorted(done) == want, (len(lanes), warps, wide, h)
        lanes = [(lanes[i], lanes[i + h]) if i + h < nv else lanes[i]
                 for i in range(h)]
        h >>= 1
    return lanes


def _fold_model(L, B, K, warps, wide, st):
    """ec_sum_kernel's fold over a cluster of K blocks of B windows
    (lanes of window b numbered b L + j): block r holds lane j K + r of
    window b at c B + b (c = j) and folds to level B; block 0 then
    gathers block q's B sums into lanes q B + b and folds them to level
    B -> the B windows' trees."""
    n = L // K
    ends = [_levels([b * L + c * K + r for c in range(n) for b in range(B)],
                    warps, wide, st, B) for r in range(K)]
    lanes = [ends[q][b] for q in range(K) for b in range(B)]
    return _levels(lanes, warps, wide, st, B) if K > 1 else lanes


def _fold_half(lo, n):
    """The plain fold's tree over lanes lo, lo + 1, ... of n lanes."""
    lanes = list(range(lo, lo + n))
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [(lanes[i], lanes[i + h]) for i in range(h)]
    return lanes[0]


def _carry_half(leaves):
    """chunk_carry_plain's tree over one column's chunk partials: C up
    to a power of two in the schedule, chunk c + h into c where it
    exists."""
    n, h = len(leaves), 1 << (len(leaves) - 1).bit_length() >> 1
    while h >= 1:
        leaves = [(leaves[c], leaves[c + h]) if c + h < n else leaves[c]
                  for c in range(h)]
        n, h = h, h // 2
    return leaves[0]


@pytest.mark.parametrize("L", [1 << k for k in range(10)])
@pytest.mark.parametrize("grp", ["Fq", "Fq2"])
def test_fold_schedule_is_fold_half(grp, L):
    """At every L up to 512, windows a block (1, 2, 3), blocks a window
    (1, 2, 4, 8: a cluster), block size, switch level (G1: all per
    thread, all staged, and levels in between; G2 every level staged,
    its thread add not compiled in) and G2 unit width (FOLD_G2_WIDTH and
    the variants'), the load covers each lane of the block's windows
    once, each add of a level runs once, and every window's result is
    the fold-half tree."""
    widths = (6,) if grp == "Fq" else (_const("FOLD_G2_WIDTH"), 32, 8)
    wides = ([0] + [1 << k for k in range(0, 10, 2)] + [1 << 30]
             if grp == "Fq" else [1 << 30])
    for width, B, K in itertools.product(widths, (1, 2, 3), (1, 2, 4, 8)):
        if K > L:
            continue
        st = _staged(grp, width)
        want = [_fold_half(b * L, L) for b in range(B)]
        n, NS = L // K, st["NS"]
        # the load: block r of the cluster, word e -> (plane, window,
        # lane); over the cluster each (plane, window, lane) once
        got = sorted((e // B // n, e % B, e // B % n * K + r)
                     for r in range(K) for e in range(8 * NS * n * B))
        assert got == [(p, b, j) for p in range(8 * NS) for b in range(B)
                       for j in range(L)]
        for warps, wide in itertools.product((1, 4, 16), wides):
            assert _fold_model(L, B, K, warps, wide, st) == want, (
                width, B, K, warps, wide)


def test_fold_plan_rule():
    """(windows a block, blocks a window, warps, widest staged level) of
    the fold at every shape a proof gives it, on a card of 132 SMs (2^17
    g1abl / g1h / b2, 2^13 g1x4 / b2, the fused radix-4 g1x4 / b2), and
    at edge cases: one window, one lane, G2 at 512 lanes, windows past
    one wave; every plan fits shared memory, B divides G, K divides L."""
    MSM._SMS["card"] = 132
    try:
        got = {(G, L, g2): MSM.fold_plan(G, L, g2, "card") for G, L, g2 in (
            (192, 128, False), (64, 128, False), (64, 128, True),
            (256, 512, False), (508, 256, False), (127, 128, True),
            (1, 4, False), (1, 512, True), (2, 1, False),
            (508, 512, True), (508, 512, False), (16, 2, False))}
    finally:
        del MSM._SMS["card"]
    assert MSM.FOLD_STAGED_MAX == {False: 96, True: 1 << 30}
    g2 = 1 << 30
    assert got == {
        (192, 128, False): (3, 2, 16, 96), (64, 128, False): (1, 2, 8, 96),
        (64, 128, True): (1, 2, 16, g2), (256, 512, False): (2, 1, 16, 96),
        (508, 256, False): (4, 1, 16, 96), (127, 128, True): (1, 1, 16, g2),
        (1, 4, False): (1, 4, 4, 96), (1, 512, True): (1, 8, 16, g2),
        (2, 1, False): (1, 1, 4, 96), (508, 512, True): (1, 8, 16, g2),
        (508, 512, False): (4, 1, 8, 96), (16, 2, False): (1, 2, 4, 96)}
    for (G, L, is_g2), (B, K, warps, wide) in got.items():
        lanes = max(L // K, K) * B
        smem = (lanes * MSM.POINT_BYTES[is_g2]
                + warps * MSM.STAGED_SCRATCH[is_g2])
        assert G % B == 0 and L % K == 0 and K <= MSM.FOLD_MAX_SPLIT
        assert smem <= MSM.SMEM and 1 <= warps <= MSM.FOLD_MAX_WARPS


@pytest.mark.parametrize("grp,width", WIDTHS)
def test_fold_staged_units_are_disjoint(grp, width):
    """In a staged level, the adds running at once (one per unit) touch
    disjoint lanes: unit adds i and i + h, and no two units share an i,
    so the lanes' writes (lane i) never meet another unit's reads."""
    st = _staged(grp, width)
    for warps in (1, 8, 16):
        units = warps * st["UNITS"]
        for h in (1, 3, 64, 256):
            for b0 in range(0, h, units):
                at_once = [b0 + u for u in range(units) if b0 + u < h]
                touched = at_once + [i + h for i in at_once]
                assert len(set(touched)) == len(touched)


@pytest.mark.parametrize("grp,width", WIDTHS)
def test_carry_schedule_covers_each_partial_and_word_once(grp, width):
    """ec_sum_kernel's carry: the load covers every (chunk, column,
    word) of a block once; at every C, columns a block, block size and
    switch level, each chunk partial of a column is added exactly once,
    no add runs for a padded chunk, and each column's sum is
    chunk_carry_plain's tree."""
    st = _staged(grp, width)
    NS = st["NS"]
    for C, B in ((1, 4), (2, 2), (3, 4), (5, 8), (8, 1), (13, 2)):
        seen = [(e // B % C, e % B, e // B // C)
                for e in range(8 * NS * C * B)]
        assert sorted(seen) == sorted((c, col, r) for c in range(C)
                                      for col in range(B)
                                      for r in range(8 * NS))
        P = 1 << (C - 1).bit_length()
        want = [_carry_half([c * B + col for c in range(C)]) for col in
                range(B)]
        for warps, wide in ((1, 0), (4, 1 << 30), (2, 2 * B)):
            lanes = [j if j < C * B else None for j in range(P * B)]
            got = _levels(lanes, warps, wide, st, B, C * B, True)
            assert got == want, (C, B, warps, wide)


def test_g2_staged_add_rounds_cover_each_lane_once():
    """hw2::point_add<W>: a stage of 24 (or 12) values runs ceil(n / W)
    rounds, lane sub taking sub, sub + W, ..; over the W lanes every
    value is taken once, and the lanes past n write nothing (product
    and combine store only below 4 np and 2 nv)."""
    body = SRC[SRC.index("__device__ __noinline__ void point_add(Fq* s, "
                         "Fq* p, const Fq* q, int sub)"):]
    for n in (24, 12):
        assert (f"for (int lane = sub; lane < sub + {n} + (W - {n} % W) % W;"
                f" lane += W)") in body
        for W in (32, 16, 8):
            took = [lane for sub in range(W)
                    for lane in range(sub, sub + n + (W - n % W) % W, W)]
            assert sorted(took) == list(range(len(took)))
            assert len(took) == -(-n // W) * W >= n
    assert "if (lane < 4 * np) s[out + lane] = r;" in SRC
    assert "if (lane < 2 * nv) out[lane] = r;" in SRC


def test_carry_plan_rule():
    """(columns, warps) of a carry block at the proofs' shapes (2^17: C =
    5, 8; 2^20 at tree_chunk 2^14: C = 64, 128) on a card of 132 SMs:
    a block an SM at least, shared memory within a block's, warps for
    the widest level."""
    MSM._SMS["card"] = 132
    try:
        got = {(C, N, g2): CT.carry_plan(C, N, g2, "card") for C, N, g2 in (
            (5, 24576, False), (8, 8192, False), (5, 8192, True),
            (64, 24576, False), (128, 8192, False), (64, 8192, True),
            (128, 8192, True), (1, 2, False), (3000, 8192, True))}
    finally:
        del MSM._SMS["card"]
    assert got == {(5, 24576, False): (128, 8), (8, 8192, False): (32, 4),
                   (5, 8192, True): (32, 16), (64, 24576, False): (32, 16),
                   (128, 8192, False): (16, 16), (64, 8192, True): (8, 8),
                   (128, 8192, True): (4, 8), (1, 2, False): (1, 4),
                   (3000, 8192, True): (1, 1)}
    for (C, N, g2), (B, warps) in got.items():
        smem = C * B * MSM.POINT_BYTES[g2] + warps * CT.CARRY_SCRATCH[g2]
        assert N % B == 0 and (smem <= MSM.SMEM or C == 3000)


def test_point_word_layout_matches_the_limb_planes():
    """point_word: word r of a point -> coordinate c, plane pl (G2: 2
    limb + component, field.cuh's layout), slot c * per + component and
    limb; the NS slots hold hw1::P's / hw2::P's order."""
    body = re.search(r"void point_word\(.*?\n\}", SRC, re.S).group(0)
    assert "c = r / (8 * per);" in body and "limb = pl / per;" in body
    for grp, per in (("Fq", 1), ("Fq2", 2)):
        assert _staged(grp)["NS"] == 3 * per
        seen = set()
        for r in range(8 * 3 * per):
            c, pl = r // (8 * per), r % (8 * per)
            slot, limb = c * per + pl % per, pl // per
            assert (pl == limb) if per == 1 else (pl == 2 * limb + slot % 2)
            seen.add((slot, limb))
        assert len(seen) == 8 * 3 * per
