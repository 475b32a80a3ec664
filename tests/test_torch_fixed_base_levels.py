"""The fixed-base table's schedule on the card (csrc/fixed_base.cu): one
warp walks the doubling ladder D_i = 2^i G into D, then the windows are
built by levels, level k making the entries d of top bit k as
T[w, d - 2^k] + D_(c w + k) (D_(c w + k) itself for d = 2^k, a copy of
T[w, d - 2^k] where c w + k is past the ladder).  A plain torch model of
that schedule on ec.point_add equals fixed_base_table_plain bit for bit
(G1 at c = 1, 4, 8, G2 at c = 4; at 4 and 8 the top window has bits
past D_254); the ladder is the doubling chain from the base; the
levels kernel's word layout of a point gives the identity's
coordinates; and the launch plan (fixed_base.level_launches, each
launch's grid and its warps' entries, parsed from the source) writes
every entry once, after every entry it reads, at every c from 1 to 16.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from za_tpu_torch.curve import G1_GEN, G2_GEN, R, g1_mul, g2_mul
from za_tpu_torch.engine import ec, field as F, fixed_base as FB

CSRC = Path(__file__).resolve().parent.parent / "za_tpu_torch" / "csrc"
SRC = (CSRC / "fixed_base.cu").read_text()
WARP_ADD = (CSRC / "warp_add.cuh").read_text()
# a c whose W c covers the whole ladder D_0 .. D_254, for each group
FULL_LADDER_C = {False: 8, True: 4}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _base(g2: bool):
    """k G for a k drawn from a seed: packed l32 (8[,2], 1)."""
    k = int.from_bytes(np.random.default_rng(18 + g2).bytes(32), "big") % R
    pt = g2_mul(G2_GEN, k) if g2 else g1_mul(G1_GEN, k)
    return ec.points_to_device([pt], g2, "cpu")


@functools.lru_cache(maxsize=None)
def _ladder(g2: bool):
    """D_0 .. D_254, packed, through the wrapper (its plain version on
    the CPU)."""
    c = FULL_LADDER_C[g2]
    assert FB.ladder_points(c) == FB.LADDER
    return FB.fixed_base_ladder(_base(g2), c, g2)


@functools.lru_cache(maxsize=None)
def _plain(g2: bool, c: int):
    """fixed_base_table_plain: the plain windows of the plain ladder,
    whose first ladder_points(c) points are the whole ladder's."""
    n = FB.ladder_points(c)
    return FB.fixed_base_windows_plain(
        tuple(x[..., :n] for x in _ladder(g2)), c, g2)


def _cols(pt, idx):
    return tuple(x[..., idx] for x in pt)


def table_by_levels(ladder, c: int, g2: bool):
    """The kernels' schedule: T[w, 0] the identity, then level k = 0 ..
    c - 1 over every window at once: T[w, 2^k] = D_(c w + k), T[w, 2^k +
    i] = T[w, i] + D_(c w + k) for 0 < i < 2^k, or T[w, i] (the identity
    for i = 0) where c w + k is past the ladder's n points."""
    fld = ec.field_of(g2)
    W, B = FB.windows(c), 1 << c
    n = FB.ladder_points(c)
    lad = tuple(F.unpack(x)[..., :n] for x in ladder)
    like = lad[0][..., :1].expand(tuple(lad[0].shape[:-1]) + (W * B,))
    tab = [x.clone() for x in FB._identity(torch.zeros_like(like), fld)]
    for k in range(c):
        h = 1 << k
        on = [w for w in range(W) if c * w + k < n]
        past = [w for w in range(W) if c * w + k >= n]
        if on:
            top = torch.tensor([w * B + h for w in on])
            for x, d in zip(tab, lad):
                x[..., top] = d[..., [c * w + k for w in on]]
        if on and h > 1:
            i = torch.arange(1, h)
            src = torch.tensor([w * B + j for w in on for j in i.tolist()])
            dj = [c * w + k for w in on for _ in i.tolist()]
            s = ec.point_add(_cols(tab, src), _cols(lad, dj), fld)
            for x, v in zip(tab, s):
                x[..., src + h] = v
        if past:
            src = torch.tensor([w * B + j for w in past for j in range(h)])
            for x in tab:
                x[..., src + h] = x[..., src]
    return tuple(F.pack(x) for x in tab)


@pytest.mark.parametrize("g2, c", [(False, 1), (False, 4), (False, 8),
                                   (True, 4)], ids=["g1-c1", "g1-c4",
                                                    "g1-c8", "g2-c4"])
def test_levels_equal_the_plain_table(g2, c):
    """The ladder, then the windows by levels, give the plain table's
    coordinates bit for bit (the same adds in the same order)."""
    got = table_by_levels(_ladder(g2), c, g2)
    want = _plain(g2, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_ladder_is_the_doubling_chain(g2):
    """D_0 is the base and D_(i+1) = D_i + D_i (the complete add of a
    point to itself, which the warp's staged add computes): all 254
    doublings in one batched add."""
    lad = tuple(F.unpack(x) for x in _ladder(g2))
    base = tuple(F.unpack(x) for x in _base(g2))
    assert all(torch.equal(d[..., :1], b) for d, b in zip(lad, base))
    prev = _cols(lad, slice(0, FB.LADDER - 1))
    dbl = ec.point_add(prev, prev, ec.field_of(g2))
    assert all(torch.equal(a, b[..., 1:]) for a, b in zip(dbl, lad))


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _has(line: str, src: str = SRC) -> bool:
    """src holds line, whitespace runs taken as one space."""
    return " ".join(line.split()) in " ".join(src.split())


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_word_layout_and_identity(g2):
    """point_word's layout of a point's 8 NS words (coordinate r / (8
    per), plane r % (8 per), slot c per + plane % per, limb plane /
    per; per = NS / 3 Fq a coordinate) and the levels kernel's identity
    word (QParams::one at slot NS / 3, Y's c0), transcribed, give the
    packed (8[,2]) coordinates of the identity (0 : 1 : 0), each plane
    once."""
    for line in ("c = r / (8 * per);", "pl = r % (8 * per);",
                 "slot = c * per + pl % per;", "limb = pl / per;",
                 "static constexpr int NS = 3, UNITS = 5, WIDTH = 6;",
                 "static constexpr int NS = 6, UNITS = 32 / W, WIDTH = W;"):
        assert _has(line, WARP_ADD), line
    assert SRC.count("slot == S::NS / 3 ? QParams::one(limb) : 0u") == 2
    ns = 6 if g2 else 3
    per = ns // 3
    one = F.FQ.to_mont_int(1)
    words = [[None] * (8 * per) for _ in range(3)]
    for r in range(8 * ns):
        co, pl = r // (8 * per), r % (8 * per)
        slot, limb = co * per + pl % per, pl // per
        assert words[co][pl] is None
        words[co][pl] = ((one >> (32 * limb)) & 0xFFFFFFFF
                         if slot == ns // 3 else 0)
    like = F.unpack(_base(g2)[0])
    want = [F.pack(x) for x in FB._identity(like, ec.field_of(g2))]
    got = [torch.tensor(w, dtype=torch.int64).reshape(want[0].shape) for w in
           words]
    assert all(torch.equal(a.to(torch.int64) & 0xFFFFFFFF, b)
               for a, b in zip(want, got))


def test_launch_plan_writes_each_entry_once_after_its_reads():
    """The table's launches at every c the wrapper takes: the ladder
    writes D; fixed_base.level_launches(c) gives the levels launches,
    each one the C entry point accepts; a launch from k0 runs W 2^max(0,
    k1 - FB_BLOCK_LEVELS) blocks of FB_WARPS warps, and the one from
    level 0 writes T[w, 0]; its levels run in order, __syncthreads
    between them (one block a window where there are several); a warp
    takes an entry at a time.  Every entry is written once, and each add
    or copy reads entries written at an earlier step (an earlier launch,
    or an earlier level of its block)."""
    for line in (
            "const int n = min(c * W, FB_LADDER);",
            "const unsigned per = gridDim.x / W;",
            "const int w = blockIdx.x / per;",
            "const unsigned v = (blockIdx.x % per) * FB_WARPS + warp;",
            "const unsigned nv = per * FB_WARPS;",
            "const size_t e0 = (size_t)w << c;",
            "if (k0 == 0 && v == 0)",
            "(co == 0 ? TX : co == 1 ? TY : TZ)[pl * entries + e0] =",
            "const int j = c * w + k;",
            "const bool past = j >= n;",
            "for (unsigned i = v; i < h; i += nv) {",
            "const size_t e = e0 + h + i;",
            "const bool sum = i > 0 && !past;",
            "s[S::P + slot].v[limb] = t[e0 + i];",
            "s[S::Q + slot].v[limb] = d;",
            "t[e] = !past ? d : i ? t[e0 + i]",
            "S::add(s, s + S::P, s + S::Q, lane);",
            "(co == 0 ? TX : co == 1 ? TY : TZ)[pl * entries + e] =",
            "if (k + 1 < k1) __syncthreads();",
            "if (c < 1 || c > 16 || W <= 0 || k0 < 0 || k1 <= k0 || k1 > c "
            "|| (k1 > FB_BLOCK_LEVELS && k1 - k0 > 1))",
            "const unsigned blocks = (unsigned)W << max(0, k1 - "
            "FB_BLOCK_LEVELS);",
            "<<<blocks, 32 * FB_WARPS, 0, (cudaStream_t)stream>>>("):
        assert _has(line), line
    nw, kb, ladder = (_const("FB_WARPS"), _const("FB_BLOCK_LEVELS"),
                      _const("FB_LADDER"))
    assert ladder == FB.LADDER and kb == FB.BLOCK_LEVELS
    assert nw == 1 << (kb - 1)
    for c in range(1, FB.MAX_WINDOW + 1):
        W, B = FB.windows(c), 1 << c
        n = FB.ladder_points(c)
        when = np.full(W * B, -1)   # entry -> the step that wrote it
        step = 0

        def write(es):
            assert (when[es] < 0).all() and len(np.unique(es)) == len(es), c
            when[es] = step

        plan = FB.level_launches(c)
        assert [k for k0, k1 in plan for k in range(k0, k1)] == list(
            range(c)), c
        for k0, k1 in plan:
            assert not (k0 < 0 or k1 <= k0 or k1 > c
                        or (k1 > kb and k1 - k0 > 1)), (c, k0, k1)
            nv = (1 << max(0, k1 - kb)) * nw
            step += 1
            for w in range(W):
                e0 = w * B
                if k0 == 0:
                    write(np.array([e0]))
            for k in range(k0, k1):
                step += 1
                h = 1 << k
                for w in range(W):
                    e0, past = w * B, c * w + k >= n
                    # warp v takes i = v, v + nv, .. below h
                    i = (np.arange(nv)[:, None]
                         + nv * np.arange(-(-h // nv))[None, :]).ravel()
                    i = i[i < h]
                    assert len(np.unique(i)) == h, (c, k)
                    reads = e0 + i[i > 0]
                    assert (when[reads] >= 0).all() and (
                        when[reads] < step).all(), (c, w, k)
                    write(e0 + h + i)
        assert (when >= 0).all(), c


def test_wrappers_compose_on_the_cpu():
    """On CPU tensors fixed_base_table is fixed_base_windows of
    fixed_base_ladder, each on its plain version, and equals
    fixed_base_table_plain (c = 2: the ladder's 254 points, a prefix of
    the whole ladder); a ladder of the wrong length is refused."""
    c = 2
    got = FB.fixed_base_table(_base(False), c, False)
    assert all(torch.equal(a, b) for a, b in zip(got, _plain(False, c)))
    lad = tuple(x[..., :FB.ladder_points(c)] for x in _ladder(False))
    with pytest.raises(ValueError, match="the ladder"):
        FB.fixed_base_windows(tuple(x[..., :-1] for x in lad), c, False)
    with pytest.raises(ValueError, match="window"):
        FB.fixed_base_ladder(_base(False), 17, False)
