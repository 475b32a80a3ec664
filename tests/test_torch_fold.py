"""The MSM tail of the port: the lane fold (engine.msm.lane_fold) and the
tree's chunk carry (engine.cuda_tree.chunk_carry), plain versions on the
CPU, against the reference's msm.lane_fold (recursive doubling, not
fold-half) and its carry scan (msm_tree.tree_window_sums), and against
host arithmetic; points compared normalized.  Then a Python model of the
schedules of csrc/ec.cu's ec_fold and ec_carry kernels, their constants
and loop heads parsed from the source: every level of a fold pairs lane
i with lane i + h for each i < h exactly once, whatever the block's
warps, the level from which adds run staged and the blocks a group is
split over, so the kernel's sum is the fold-half tree of the plain
version; the carry's units and lanes cover every partial and every word
once.

The points are multiples k P of the generators by small numpy-seeded k
(G1 and G2 from the same k), so each window's expected sum is one short
host multiplication; reference compiles stay at 256 points or fewer."""

import functools
import importlib.util
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
    "if (leaves && i + 2 * h >= nv) thread_add<F, 2>(pts, i, h);",
    "else if (leaves && i + 3 * h >= nv) thread_add<F, 1>(pts, i, h);",
    "else thread_add<F, 0>(pts, i, h);",
    "for (int b = warp * S::UNITS; b < h; b += units) {",
    "const int i = b + k;",
    "const bool on = i < h && i + h < nv;",
    "S::add(s, on ? pts + i * S::NS : s + S::P,",
    "on ? pts + (i + h) * S::NS : s + S::Q, sub);",
]
FOLD_LINES = [  # ec_fold_kernel: block r of K takes lanes r, r + K, ...
    "const int n = L / K, tid = threadIdx.x, nt = blockDim.x;",
    "const int k = min(lane / S::WIDTH, S::UNITS - 1);",
    "const int sub = lane - S::WIDTH * k;",
    "pts[j * S::NS + slot].v[limb] = src[pl * plane + g * L + j * K + r];",
    "fold_levels<F>(pts, s, n, 1, n, false, wide, k, sub);",
    "const Fq* far = cluster.map_shared_rank(smem, e / S::NS + 1);",
    "pts[S::NS + e] = far[e % S::NS];",
    "fold_levels<F>(pts, s, K, 1, K, false, wide, k, sub);",
]
CARRY_LINES = [  # ec_carry_kernel: B columns, chunk-major lanes c B + col
    "const int nv = C * B, tid = threadIdx.x, nt = blockDim.x;",
    "const size_t j0 = (size_t)blockIdx.x * B;",
    "for (int e = tid; e < 8 * S::NS * nv; e += nt) {",
    "const int col = e % B, a = e / B, c = a % C;",
    "point_word<F>(a / C, cc, pl, slot, limb);",
    "const bool at_inf = inf[(size_t)c * N + j0 + col] != 0;",
    "if (cc == 2) v = at_inf ? 0u : one_w;",
    "else if (at_inf) v = cc == 1 ? one_w : 0u;",
    "else v = (cc == 0 ? x : y)[((size_t)c * 8 * per + pl) * N + j0 + col];",
    "pts[(c * B + col) * S::NS + slot].v[limb] = v;",
    "if (wide >= B) S::init(s, sub);",
    "fold_levels<F, W, THREADS>(pts, s, P * B, B, nv, true, wide, k, sub);",
    "for (int e = tid; e < 8 * S::NS * B; e += nt) {",
    "const int col = e % B;",
    "point_word<F>(e / B, c, pl, slot, limb);",
    "(c == 0 ? X : c == 1 ? Y : Z)[pl * (size_t)N + j0 + col] =",
    "pts[col * S::NS + slot].v[limb];",
]


def test_fold_and_carry_source_matches_the_model():
    levels = SRC[SRC.index("void fold_levels("):]
    levels = levels[:levels.index("\n}\n")]
    for line in LEVEL_LINES:
        assert line in levels, line
    for name, lines in (("ec_fold_kernel", FOLD_LINES),
                        ("ec_carry_kernel", CARRY_LINES)):
        body = _kernel(name)
        for line in lines:
            assert line in body, (name, line)
    assert _staged("Fq") == {"NS": 3, "UNITS": 5, "WIDTH": 6}
    assert _const("FOLD_MAX_LANES") == MSM.FOLD_MAX_LANES
    assert _const("FOLD_MAX_SPLIT") == MSM.FOLD_MAX_SPLIT
    fold_max = _const("FOLD_MAX_THREADS")
    for g2, grp in ((False, "Fq"), (True, "Fq2")):
        st = _staged(grp)
        units = st["UNITS"] * st["WIDTH"]
        assert units <= 32 and 32 * MSM.FOLD_WARPS[g2] <= fold_max
        # the widest group and its scratch fit a block's shared memory
        slots = 90 if g2 else 25      # hw2::SLOTS, hw1::SLOTS
        assert re.search(rf"constexpr int SLOTS = {slots};",
                         SRC[SRC.index(f"namespace hw{2 if g2 else 1} {{"):])
        smem = (MSM.FOLD_MAX_LANES * st["NS"]
                + MSM.FOLD_WARPS[g2] * st["UNITS"] * slots) * 32
        assert smem <= 232448
        # the carry's plan: a point's bytes, a warp's adds at once and
        # its staged scratch (G2: units of CARRY_G2_WIDTH lanes)
        assert CT.POINT_BYTES[g2] == 32 * st["NS"]
        cw = _staged(grp, _const("CARRY_G2_WIDTH")) if g2 else st
        assert CT.CARRY_PER_WARP[g2] == (cw["UNITS"] if g2 else 32)
        assert CT.CARRY_SCRATCH[g2] == (cw["UNITS"] * slots * 32 if g2
                                        else 0)
        assert CT.CARRY_STAGED_MAX[g2] == (1 << 30 if g2 else 0)
        assert CT.SMEM == 232448


def test_ptxas_names_follow_the_kernel_templates():
    """chip_smoke.KERNEL_FN names the __global__ functions whose ptxas
    registers the fold and carry rows report, by the prefix of their
    mangled names: the fold <F>, the carry <F, lanes, thread adds> at
    G1's 6 lanes with thread adds (CARRY_STAGED_MAX 0) and G2's
    CARRY_G2_WIDTH lanes, every level staged."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    heads = dict(re.findall(r"template <([^>]*)>\n__global__ void "
                            r"__launch_bounds__\(FOLD_MAX_THREADS\)\n"
                            r"(ec_fold_kernel|ec_carry_kernel)\(", SRC))
    assert {v: k for k, v in heads.items()} == {
        "ec_fold_kernel": "class F",
        "ec_carry_kernel": "class F, int W, bool THREADS"}
    fq, fq2 = "NS_2FpINS_7QParamsEEE", "NS_3Fq2E"
    assert cs.KERNEL_FN["ec_fold_g1"] == f"_ZN2za14ec_fold_kernelI{fq}EE"
    assert cs.KERNEL_FN["ec_fold_g2"] == f"_ZN2za14ec_fold_kernelI{fq2}EE"
    assert CT.CARRY_STAGED_MAX == {False: 0, True: 1 << 30}
    assert (cs.KERNEL_FN["ec_carry_g1"]
            == f"_ZN2za15ec_carry_kernelI{fq}Li6ELb1E")
    assert (cs.KERNEL_FN["ec_carry_g2"] == "_ZN2za15ec_carry_kernelI"
            f"{fq2}Li{_const('CARRY_G2_WIDTH')}ELb0E")


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


def _fold_model(L, warps, wide, split, st):
    """ec_fold_kernel over a cluster of `split` blocks: block r folds
    lanes r, r + split, ...; block 0 then folds the blocks' results."""
    n = L // split
    ends = [_levels([j * split + r for j in range(n)], warps, wide, st)[0]
            for r in range(split)]
    return _levels(ends, warps, wide, st)[0]


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
    """At every L up to 512, every block size, every switch level (all
    per thread, all staged, and each level in between) and every split
    of a group over blocks, each add of a level runs once, and the
    result is the fold-half tree."""
    st = _staged(grp)
    want = _fold_half(0, L)
    for warps in (1, 4, 16):
        for wide in [0] + [1 << k for k in range(0, 10, 2)] + [1 << 30]:
            for split in (1, 2, 4, 8):
                if split <= L:
                    assert _fold_model(L, warps, wide, split, st) == want


def test_fold_split_rule():
    """The most blocks a group (a power of two up to FOLD_MAX_SPLIT and
    L) that keep all groups' blocks to one per SM of the card."""
    MSM._SMS["card"] = 132
    try:
        got = {(G, L): MSM.fold_split(G, L, "card") for G, L in (
            (192, 128), (64, 128), (64, 512), (127, 256), (256, 128),
            (508, 64), (1, 4), (1, 512), (16, 2))}
    finally:
        del MSM._SMS["card"]
    assert got == {(192, 128): 1, (64, 128): 2, (64, 512): 2,
                   (127, 256): 1, (256, 128): 1, (508, 64): 1, (1, 4): 4,
                   (1, 512): 8, (16, 2): 2}


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
    """ec_carry_kernel: the load covers every (chunk, column, word) of a
    block once; at every C, columns a block, block size and switch
    level, each chunk partial of a column is added exactly once, no
    add runs for a padded chunk, and each column's sum is
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
        smem = C * B * CT.POINT_BYTES[g2] + warps * CT.CARRY_SCRATCH[g2]
        assert N % B == 0 and (smem <= CT.SMEM or C == 3000)


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
