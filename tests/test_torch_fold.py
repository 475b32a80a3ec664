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


def _affine(pool, idx):
    """Flagged affine partials: x, y of the pool's points (Z = 1 or the
    identity's 0) and inf where idx picks the identity."""
    X, Y, _ = _gather(pool, idx)
    return X, Y, torch.from_numpy(idx == len(POOL))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_chunk_carry_matches_reference_scan(g2):
    """Three chunks' partials (M = 1, W = 16, T = 8) into the carry:
    the reference's scan (first chunk, then point_add(carry, chunk)) and
    the port's chunk_carry give the same points, and the host sums."""
    C, W, T = 3, 16, 8
    idx = _lanes(7, (C, 1, W, T), ident=0.3)
    idx[1, 0, 3] = len(POOL)               # a window at infinity in one chunk
    pool = _pool(g2)
    acc = None
    for c in range(C):
        acc = CT.chunk_carry(acc, *_affine(pool, idx[c]), g2)
    to_rns = ZEC.g2_points_to_rns if g2 else ZEC.g1_points_to_rns
    ops = _ref_ops(g2)
    add = jax.jit(lambda a, b: ZEC.point_add(a, b, ops))
    ref = None
    for c in range(C):
        part = to_rns(_ref_points(idx[c], g2))
        ref = part if ref is None else add(ref, part)
    assert (_normalized(acc, g2) == _from_ref(ref, W * T, g2)
            == _expected(idx, 0, g2))


def test_chunk_carry_first_chunk_is_proj_of_affine():
    """The first chunk's carry is msm_tree.proj_of_affine's points: (x :
    y : 1), and (0 : 1 : 0) exactly where flagged."""
    idx = _lanes(3, (2, 4, 8), ident=0.5)
    X, Y, inf = _affine(_pool(False), idx)
    got = CT.chunk_carry(None, X, Y, inf, False)
    want = ec.identity_like(X, False)
    one = want[1]
    for a, b in zip(got, (torch.where(inf, want[0], X),
                          torch.where(inf, one, Y),
                          torch.where(inf, want[2], one))):
        assert torch.equal(a, b)


# -- the kernels' schedules, modelled from csrc/ec.cu ---------------------------


def _staged(group: str) -> dict:
    """Staged<Fq> / Staged<Fq2>'s constants."""
    body = re.search(r"template <> struct Staged<" + group + r"> \{(.*?)\n\};",
                     SRC, re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _kernel(name: str) -> str:
    start = SRC.index(f"\n{name}(")
    return SRC[start:SRC.index("\n}\n", start)]


LEVEL_LINES = [  # the loops the model below runs, as fold_levels has them
    "for (int h = n >> 1; h > 0; h >>= 1) {",
    "if (h > wide) {",
    "for (int i = tid; i < h; i += nt) thread_add<F>(pts, i, h);",
    "for (int b = warp * S::UNITS; b < h; b += units) {",
    "const int i = b + k;",
    "S::add(s, i < h ? pts + i * S::NS : s + S::P,",
    "i < h ? pts + (i + h) * S::NS : s + S::Q, sub);",
]
FOLD_LINES = [  # ec_fold_kernel: block r of K takes lanes r, r + K, ...
    "const int n = L / K, tid = threadIdx.x, nt = blockDim.x;",
    "const int k = min(lane / S::WIDTH, S::UNITS - 1);",
    "const int sub = lane - S::WIDTH * k;",
    "pts[j * S::NS + slot].v[limb] = src[pl * plane + g * L + j * K + r];",
    "fold_levels<F>(pts, s, n, wide, k, sub);",
    "const Fq* far = cluster.map_shared_rank(smem, e / S::NS + 1);",
    "pts[S::NS + e] = far[e % S::NS];",
    "fold_levels<F>(pts, s, K, wide, k, sub);",
]


def test_fold_and_carry_source_matches_the_model():
    levels = SRC[SRC.index("void fold_levels("):]
    levels = levels[:levels.index("\n}\n")]
    for line in LEVEL_LINES:
        assert line in levels, line
    fold = _kernel("ec_fold_kernel")
    for line in FOLD_LINES:
        assert line in fold, line
    carry = _kernel("ec_carry_kernel")
    for line in ("((size_t)blockIdx.x * CARRY_WARPS + warp) * S::UNITS + k;",
                 "const bool on = i < (size_t)n && sub < S::WIDTH;",
                 "for (int r = sub; r < 8 * S::NS; r += S::WIDTH) {"):
        assert line in carry, line
    assert _staged("Fq") == {"NS": 3, "UNITS": 5, "WIDTH": 6}
    assert _staged("Fq2") == {"NS": 6, "UNITS": 1, "WIDTH": 32}
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


def _levels(lanes, warps, wide, st):
    """fold_levels on one block's lanes (trees: nested pairs of input
    lane numbers): each level's adds by worker, each i < h once -> the
    tree left in lane 0."""
    nt, units = 32 * warps, warps * st["UNITS"]
    h = len(lanes) >> 1
    while h > 0:
        done = []
        if h > wide:
            for tid in range(nt):
                done += [i for i in range(tid, h, nt)]
        else:
            for lane in range(32):
                k = min(lane // st["WIDTH"], st["UNITS"] - 1)
                sub = lane - st["WIDTH"] * k
                if sub != 0:          # one record per unit (its lane 0)
                    continue
                for warp in range(warps):
                    for b in range(warp * st["UNITS"], h, units):
                        if b + k < h:
                            done.append(b + k)
        assert sorted(done) == list(range(h)), (len(lanes), warps, wide, h)
        lanes = [(lanes[i], lanes[i + h]) for i in range(h)] + lanes[h:]
        h >>= 1
    return lanes[0]


def _fold_model(L, warps, wide, split, st):
    """ec_fold_kernel over a cluster of `split` blocks: block r folds
    lanes r, r + split, ...; block 0 then folds the blocks' results."""
    n = L // split
    ends = [_levels([j * split + r for j in range(n)], warps, wide, st)
            for r in range(split)]
    return _levels(ends, warps, wide, st)


def _fold_half(lo, n):
    """The plain fold's tree over lanes lo, lo + 1, ... of n lanes."""
    lanes = list(range(lo, lo + n))
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [(lanes[i], lanes[i + h]) for i in range(h)]
    return lanes[0]


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


@pytest.mark.parametrize("grp", ["Fq", "Fq2"])
def test_fold_staged_units_are_disjoint(grp):
    """In a staged level, the adds running at once (one per unit) touch
    disjoint lanes: unit adds i and i + h, and no two units share an i,
    so the lanes' writes (lane i) never meet another unit's reads."""
    st = _staged(grp)
    for warps in (1, 8, 16):
        units = warps * st["UNITS"]
        for h in (1, 3, 64, 256):
            for b0 in range(0, h, units):
                at_once = [b0 + u for u in range(units) if b0 + u < h]
                touched = at_once + [i + h for i in at_once]
                assert len(set(touched)) == len(touched)


@pytest.mark.parametrize("grp", ["Fq", "Fq2"])
def test_carry_schedule_covers_each_partial_and_word_once(grp):
    """ec_carry_kernel: partial i = (block * CARRY_WARPS + warp) * UNITS
    + k over the grid covers 0..n-1 once; a unit's lanes sub < WIDTH
    load and store each of a point's 8 NS words once."""
    st, cw = _staged(grp), _const("CARRY_WARPS")
    per = cw * st["UNITS"]
    for n in (1, 7, 8192, 24576):
        seen = []
        for blk in range(-(-n // per)):
            for warp in range(cw):
                for k in range(st["UNITS"]):
                    i = (blk * cw + warp) * st["UNITS"] + k
                    if i < n:
                        seen.append(i)
        assert sorted(seen) == list(range(n))
    words = [r for sub in range(st["WIDTH"])
             for r in range(sub, 8 * st["NS"], st["WIDTH"])]
    assert sorted(words) == list(range(8 * st["NS"]))
    assert st["UNITS"] * st["WIDTH"] <= 32


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
