"""On an NVIDIA card: every CUDA kernel of the port against its plain
PyTorch version on the same inputs, exact equality.  Skips without a
card (the full-width comparison is chip_smoke.py's)."""

import random

import numpy as np
import pytest
import torch

from za_tpu_torch.curve import G1_GEN, G2_GEN, Q, R, g1_mul, g2_mul
from za_tpu_torch.engine import cuda_tree as CT, ec, field as F
from za_tpu_torch.engine import fixed_base as FB
from za_tpu_torch.engine import msm as MSM, msm_dense as MD
from za_tpu_torch.engine import msm_tree as MT, ntt as NTT, r1cs as RC

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(7)


def _rand_fq(shape, gen):
    limbs = torch.randint(0, 1 << 16, (16,) + tuple(shape), generator=gen,
                          dtype=torch.int64, device="cuda")
    limbs[15] = torch.randint(0, 0x3064, tuple(shape), generator=gen,
                              dtype=torch.int64, device="cuda")
    return F.pack(limbs)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_ec_kernels_match_plain(gen, is_g2):
    E = (2,) if is_g2 else ()
    p = [_rand_fq(E + (1000,), gen) for _ in range(6)]
    assert _same(ec.ec_add(p[:3], p[3:], is_g2),
                 ec.ec_add_plain(p[:3], p[3:], is_g2))
    assert _same(ec.to_affine(*p[:3], is_g2),
                 ec.to_affine_plain(*p[:3], is_g2))
    for bits, W in MSM.WINDOWS.items():
        w = [_rand_fq(E + (3, W), gen) for _ in range(3)]
        assert _same(MSM.horner_windows(w, is_g2, bits),
                     MSM.horner_windows_plain(w, is_g2, bits))


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("n", [1, 1023, 5000, 3 * 1024, (1 << 18) - 77])
def test_to_affine_g1_zero_z_and_ragged_blocks(gen, n, is_g2):
    """to_affine_g1 and _g2 (one wave, inv_gcd at each block's root; G2
    through the norm): every seventh Z zero, a whole block's Z zero (n
    = 3 * 1024), a partial last block and thread column; in G2 Z with
    one zero component."""
    E = (2,) if is_g2 else ()
    p = [_rand_fq(E + (n,), gen) for _ in range(3)]
    p[2][..., ::7] = 0
    if is_g2:
        p[2][:, 0, 1::7] = 0
        p[2][:, 1, 2::7] = 0
    if n == 3 * 1024:
        p[2][..., 1024:2048] = 0
    assert _same(ec.to_affine(*p, is_g2), ec.to_affine_plain(*p, is_g2))


@pytest.mark.parametrize("n", [1, 1000, (1 << 14) - 77, 1 << 14,
                               (1 << 15) - 77])
def test_ec_add_g2_ragged_and_dense_width(gen, n):
    """ec_add_g2 at ragged n, at the 2^13 rung's dense width (2^14
    points) and near a staging block's, with identities (Z = 0), Z
    with one zero component and doublings (P = Q) among the pairs."""
    p = [_rand_fq((2, n), gen) for _ in range(6)]
    p[2][..., ::7] = 0
    p[5][..., 3::7] = 0
    p[2][:, 0, 1::7] = 0
    p[5][:, 1, 2::7] = 0
    for a, b in zip(p[:3], p[3:]):
        b[..., 5::11] = a[..., 5::11]
    assert _same(ec.ec_add(p[:3], p[3:], True),
                 ec.ec_add_plain(p[:3], p[3:], True))


@pytest.mark.parametrize("B,S,L,start,store", [
    (3, 1024, 2048, 1024, False), (3, 2048, 1024, 1024, False),
    (1, 2048, 1024, 1024, True), (2, 64, 24, 8, False),
    (1, 256, 8, 2, True)], ids=["a", "b", "c", "t3", "8-stages-store"])
def test_ntt_stage_kernel_matches_plain(gen, B, S, L, start, store):
    """The tail kernel at the 2^20 rung's sub-NTT tails (a) 3 x 1024 x
    2048, one stage, (b) 3 x 2048 x 1024, two, (c) the same on one leg
    with the store mode; three stages in one launch at a lane count off
    the warp; eight stages (three launches) ending in the store mode."""
    tw = NTT._twiddles(NTT.Domain(S).omega, S // 2, "cuda")
    x = _rand_fq((B, S, L), gen)   # top limb < 0x3064: canonical mod r
    table = _rand_fq((S * L,), gen) if store else None
    before = NTT.NTT_STAGE.launches
    got = NTT.ntt_stages(x, tw, start, scale_out=table)
    stages = (S // start).bit_length()
    assert NTT.NTT_STAGE.launches - before == -(-stages //
                                                 NTT.TAIL_MAX_STAGES)
    assert got.shape == (16 if store else 8, B, S, L)
    assert torch.equal(got, NTT.ntt_stages_plain(x, tw, start, table))


@pytest.mark.parametrize("S,L,m", [(512, 512, 512), (256, 64, 16),
                                   (64, 8, 4)])
def test_ntt_prefix_kernel_matches_plain(gen, S, L, m):
    """The 2^18 sub-NTT shape, a partial prefix and the smallest one."""
    tw = NTT._twiddles(NTT.Domain(S).omega, S // 2, "cuda")
    x = _rand_fq((3, S, L), gen)
    assert torch.equal(NTT.ntt_prefix(x, tw, m),
                       NTT.ntt_prefix_plain(x, tw, m))


def test_ntt_prefix_refuses_a_block_over_shared_memory(gen):
    """m = 1024 rows: more than one prefix tile holds (PREFIX_ROWS,
    whose 8 lanes x 32 B fill 128 KB of shared memory).  The wrapper
    raises, counts no launch, and the next launch runs."""
    S = 1024
    tw = NTT._twiddles(NTT.Domain(S).omega, S // 2, "cuda")
    x = _rand_fq((1, S, 8), gen)
    before = NTT.NTT_PREFIX.launches
    with pytest.raises(RuntimeError, match="ntt_prefix_fr"):
        NTT.ntt_prefix(x, tw, S)
    assert NTT.NTT_PREFIX.launches == before
    assert torch.equal(NTT.ntt_prefix(x, tw, S // 2),
                       NTT.ntt_prefix_plain(x, tw, S // 2))


# (S, L, m) and the prefix modes: the 2^18 sub-NTT shape, S = 64 (one
# pass of 3 stages, then 3 more), a partial prefix (m = 16) and m = 4
# (one pass); the store mode only where the prefix ends the transform
PREFIX_MODE_CASES = [
    (S, L, m, mode)
    for S, L, m in [(512, 512, 512), (64, 8, 64), (256, 64, 16), (32, 16, 4)]
    for mode in ("scale_in", "combine", "scale_out", "combine+scale_out")
    if "scale_out" not in mode or m == S]


@pytest.mark.parametrize("S,L,m,mode", PREFIX_MODE_CASES)
def test_ntt_prefix_modes_match_plain(gen, S, L, m, mode):
    tw = NTT._twiddles(NTT.Domain(S).omega, S // 2, "cuda")
    kw = {"combine": "combine" in mode}
    for k in ("scale_in", "scale_out"):
        if k in mode:
            kw[k] = _rand_fq((S * L,), gen)
    x = _rand_fq((6 if kw["combine"] else 2, S, L), gen)
    before = dict(NTT.PREFIX_LAUNCHES)
    got = NTT.ntt_prefix(x, tw, m, **kw)
    assert NTT.PREFIX_LAUNCHES[mode] == before.get(mode, 0) + 1
    want = NTT.ntt_prefix_plain(x, tw, m, **kw)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("size,m_fuse", [(1 << 12, 64), (1 << 10, 32),
                                         (1 << 12, 16)])
def test_h_transforms_match_plain(gen, monkeypatch, size, m_fuse):
    """h(x)'s three transforms at 2^12 and 2^10 (the four-step, every
    prefix mode) and at 2^12 with the prefix cut to 16 rows, so that
    every sub-NTT ends in a tail of two stages, the coset iNTT's with
    the store mode: against the plain versions on the CPU."""
    monkeypatch.setattr(NTT, "PREFIX_SMEM_BYTES",
                        m_fuse * NTT.PREFIX_LANES * 32)
    legs = _rand_fq((3, size), gen)
    dom = NTT.DeviceDomain(size, "cuda")
    assert NTT.prefix_rows(dom.fourstep.n2, dom.fourstep.n1) == m_fuse
    before = NTT.NTT_STAGE.launches
    got = NTT.h_transforms(dom, legs)
    assert NTT.NTT_STAGE.launches - before == (6 if m_fuse == 16 else 0)
    want = NTT.h_transforms(NTT.DeviceDomain(size, "cpu"), legs.cpu())
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def _rows(rng, n, nv, long_rows):
    """n rows of 0-3 entries, the rows in long_rows with that many."""
    rows = []
    for i in range(n):
        k = long_rows.get(i, rng.randrange(4))
        rows.append([(rng.randrange(nv), rng.randrange(R)) for _ in range(k)])
    return rows


def test_r1cs_matvec_kernel_matches_plain(gen):
    """Short rows (one thread each), rows just over and far over
    WARP_ROW (one warp each, two in one warp's 32 rows), a row of 5000,
    empty rows and the rows past the constraints."""
    rng = random.Random(3)
    nv, n, m = 300, 900, 1024
    w = RC.WARP_ROW
    legs = (_rows(rng, n, nv, {5: w, 40: w + 1, 41: 3 * w, 700: 5000}),
            _rows(rng, n - 100, nv, {}),
            _rows(rng, n, nv, {0: 33, 31: 64}))
    csr = RC.pack_csr(legs, m, "cuda")
    z = F.unpack(_rand_fq((nv,), gen)).to(torch.int32)   # (16, nv) limbs
    before = RC.R1CS_MATVEC.launches
    got = RC.matvec(csr, z)
    assert RC.R1CS_MATVEC.launches == before + 1
    assert torch.equal(got.cpu(), RC.matvec_plain(
        RC.pack_csr(legs, m, "cpu"), z.cpu()))
    with pytest.raises(ValueError):
        RC.matvec(csr, F.pack(z.to(torch.int64)))     # l32 is refused


def test_ntt_twiddle_kernel_matches_plain(gen):
    """n2 = 64 rows, n1 = 128 columns (the 2^13 split) and a ragged
    shape that no tile divides."""
    fs = NTT.DeviceDomain(1 << 13, "cuda").fourstep
    a = _rand_fq((3, fs.n2, fs.n1), gen)
    assert torch.equal(NTT.ntt_twiddle(a, fs.inter_inv),
                       NTT.ntt_twiddle_plain(a, fs.inter_inv))
    a, inter = _rand_fq((2, 40, 72), gen), _rand_fq((40, 72), gen)
    assert torch.equal(NTT.ntt_twiddle(a, inter),
                       NTT.ntt_twiddle_plain(a, inter))


@pytest.mark.parametrize("B,R_,C", [(3, 512, 512), (3, 128, 128),
                                    (1, 37, 70), (2, 36, 70), (1, 4, 3)])
def test_ntt_twiddle_kernel_shapes(gen, B, R_, C):
    """The vector path (R and C multiples of four: both rungs' shapes,
    a partial tile) and the word-by-word one (R or C not), and an
    offset view that is not 16-byte aligned."""
    a, inter = _rand_fq((B, R_, C), gen), _rand_fq((R_, C), gen)
    assert torch.equal(NTT.ntt_twiddle(a, inter),
                       NTT.ntt_twiddle_plain(a, inter))
    buf = torch.empty(a.numel() + 1, dtype=torch.int32, device="cuda")
    buf[1:] = a.reshape(-1)
    a = buf[1:].view(a.shape)               # contiguous, 4 bytes off
    assert a.is_contiguous() and a.data_ptr() % 16
    assert torch.equal(NTT.ntt_twiddle(a, inter),
                       NTT.ntt_twiddle_plain(a, inter))


def test_fourstep_kernels_match_plain(gen):
    """A whole 2^12 transform: sub_ntt / twiddle / sub_ntt on the card
    against the same steps' plain versions."""
    dom = NTT.DeviceDomain(1 << 12, "cuda")
    fs = dom.fourstep
    x = _rand_fq((3, dom.size), gen)
    got = NTT.fourstep_core(x, *fs.tables(True), fs.n1, fs.n2)
    a = NTT.sub_ntt_plain(x.reshape(8, 3, fs.n2, fs.n1), fs.t2_inv, fs.n2)
    a = NTT.sub_ntt_plain(NTT.ntt_twiddle_plain(a, fs.inter_inv),
                          fs.t1_inv, fs.n1)
    assert torch.equal(got, a.reshape(8, 3, dom.size))


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_tree_kernels_match_plain(gen, is_g2):
    E = (2,) if is_g2 else ()
    M, S, W = 2, 1024, 64
    tx = _rand_fq((MT.HALF,) + E + (M, S), gen).movedim(0, 1).contiguous()
    ty = _rand_fq((MT.HALF,) + E + (M, S), gen).movedim(0, 1).contiguous()
    d = torch.randint(-8, 9, (W, M, S), generator=gen,
                      device="cuda").to(torch.int8)
    out = CT.tree_level0(tx, ty, d, is_g2)
    assert _same(out, MT.tree_level0_plain(tx, ty, d, is_g2))
    assert _same(CT.tree_level(*out, is_g2), MT.tree_level_plain(*out, is_g2))


@pytest.mark.parametrize("radix", [16, 4])
@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_dense_kernels_match_plain(gen, is_g2, radix):
    """Random tables and digits; n = 300 is not a multiple of L = 64."""
    E = (2,) if is_g2 else ()
    M, n, L = 2, 300, 64
    K = MD.MULTIPLES[radix]
    tabs = MD.DenseTables(
        *(_rand_fq((K,) + E + (M, n), gen).movedim(0, 1).contiguous()
          for _ in range(3)), is_g2=is_g2)
    W = MSM.WINDOWS[MD.BITS[radix]]
    lo, hi = (-8, 9) if radix == 16 else (0, 4)
    d = torch.randint(lo, hi, (W, M, n), generator=gen,
                      device="cuda").to(torch.int8)
    assert _same(MD.dense_window_sums(tabs, d, L),
                 MD.dense_window_sums_plain(tabs, d, L))


@pytest.mark.parametrize("radix", [16, 4])
@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_dense_segments_match_plain(gen, is_g2, radix):
    """S segments a lane folded in the block: n = 1000 is not a multiple
    of L or S L; S from 2 to DTB, blocks that span several windows (L <
    DTB / S) and the (L, S) the card's plan gives; a bad S raises."""
    E = (2,) if is_g2 else ()
    M, n = 3, 1000
    K = MD.MULTIPLES[radix]
    tabs = MD.DenseTables(
        *(_rand_fq((K,) + E + (M, n), gen).movedim(0, 1).contiguous()
          for _ in range(3)), is_g2=is_g2)
    W = MSM.WINDOWS[MD.BITS[radix]]
    lo, hi = (-8, 9) if radix == 16 else (0, 4)
    d = torch.randint(lo, hi, (W, M, n), generator=gen,
                      device="cuda").to(torch.int8)
    d[:, 1, 500:] = 0     # query 1 padded, as staged queries are
    L, S = MD.plan(tabs)
    assert (L, S) == MD.lanes(M, n, radix, is_g2, MSM.sm_count(d.device)
                              * MD.resident_blocks(radix, is_g2, d.device))
    for L, S in {(L, S), (64, 4), (8, 8), (2, MD.DTB), (512, 2)}:
        assert _same(MD.dense_window_sums(tabs, d, L, S),
                     MD.dense_window_sums_plain(tabs, d, L, S)), (L, S)
    for S in (3, 2 * MD.DTB):
        with pytest.raises(ValueError):
            MD.dense_window_sums(tabs, d, 8, S)


# pairs per block of the tree kernels: TB * G1_K, TB * G2_K in
# csrc/tree.cu
BLOCK_PAIRS = {False: 128 * 8, True: 128 * 4}


def _dev_points(vals, is_g2, W, n):
    """W rows of n Fq (G1) or (c0, c1) (G2) ints -> (8, *E, 1, W, n)."""
    flat = [v for row in vals for v in row]
    a = (np.stack([F.ints_to_l32([v[c] for v in flat]) for c in (0, 1)],
                  axis=1) if is_g2 else F.ints_to_l32(flat))
    return torch.from_numpy(a).reshape(a.shape[:-1] + (1, W, n)).cuda()


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_tree_level_edge_blocks(gen, is_g2):
    """n/2 = 2 B + 300 pairs per row (B pairs a block): three blocks,
    the last one ragged.  Row 0: block 0 has no live pair (its product
    is 1), block 1 one.  Row 1: each block's one live pair has the
    denominator 1, q - 1 (as residues) and R mod q (the field's one) in
    G1; 1, q - 1 and i (c0 = 0, c1 = R mod q) in G2, so the inversion
    sees exactly these values (in G2 through their norms)."""
    rng = random.Random(5)
    B = BLOCK_PAIRS[is_g2]
    half, W = 2 * B + 300, 2

    def rand():
        return (rng.randrange(Q), rng.randrange(Q)) if is_g2 else \
            rng.randrange(Q)

    x = [[rand() for _ in range(2 * half)] for _ in range(W)]
    y = [[rand() for _ in range(2 * half)] for _ in range(W)]
    inf = [[False] * (2 * half) for _ in range(W)]
    # pairs (p, p + half): in blocks 0 and 1 of row 0 and all of row 1
    # every pair has an operand at infinity (left, right or both) ...
    for w in range(W):
        for p in range(2 * B if w == 0 else half):
            side = rng.randrange(3)
            inf[w][p] = side != 1
            inf[w][p + half] = side != 0
    # ... but these
    dens = ([(1, 0), (Q - 1, 0), (0, (1 << 256) % Q)] if is_g2 else
            [1, Q - 1, (1 << 256) % Q])
    live = {(0, B + 476): None, (1, 7): dens[0], (1, B + 6): dens[1],
            (1, 2 * B + 52): dens[2]}
    for (w, p), den in live.items():
        inf[w][p] = inf[w][p + half] = False
        if den is None:
            continue
        if is_g2:
            x[w][p + half] = tuple((a + b) % Q for a, b in zip(x[w][p], den))
        else:
            x[w][p + half] = (x[w][p] + den) % Q
    for p in range(2 * B, half):   # block 2 of row 0: 1 in 10 at inf
        inf[0][p] = rng.random() < 0.1

    args = (_dev_points(x, is_g2, W, 2 * half),
            _dev_points(y, is_g2, W, 2 * half),
            torch.tensor(inf).reshape(1, W, 2 * half).cuda(), is_g2)
    assert _same(CT.tree_level(*args), MT.tree_level_plain(*args))


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_tree_level0_g2_ragged_and_idle_blocks(gen, is_g2):
    """S/2 = B + 212 pairs per row (B pairs a block: 1024 in G1, 512 in
    G2), not a multiple of B; in row 1 every left digit of block 0 is
    zero (each pair takes its right operand, the block's product is 1),
    in row 2 every digit of the ragged block 1 on both sides."""
    E = (2,) if is_g2 else ()
    B = BLOCK_PAIRS[is_g2]
    M, W, half = 1, 3, B + 212
    S = 2 * half
    tx = _rand_fq((MT.HALF,) + E + (M, S), gen).movedim(0, 1).contiguous()
    ty = _rand_fq((MT.HALF,) + E + (M, S), gen).movedim(0, 1).contiguous()
    d = torch.randint(-8, 9, (W, M, S), generator=gen,
                      device="cuda").to(torch.int8)
    d[1, :, :B] = 0
    d[2, :, B:half] = 0
    d[2, :, half + B:] = 0
    assert _same(CT.tree_level0(tx, ty, d, is_g2),
                 MT.tree_level0_plain(tx, ty, d, is_g2))


@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_horner_g2_identity_windows(gen, is_g2, bits, M):
    """Window sums at the identity (0 : 1 : 0): M = 3 has MSM 0 all
    identity, MSM 1 only its first window read (the top one), MSM 2 only
    its last (window 0); M = 1 only its first."""
    W = MSM.WINDOWS[bits]
    E = (2,) if is_g2 else ()
    w = [_rand_fq(E + (M, W), gen) for _ in range(3)]
    ident = ec.identity_like(w[0], is_g2)
    where = [slice(W - 1, W)] if M == 1 else [
        slice(None), slice(W - 1, W), slice(0, 1)]
    for m, sel in enumerate(where):
        for c, i in zip(w, ident):
            c[..., m, sel] = i[..., m, sel]
    assert _same(MSM.horner_windows(w, is_g2, bits),
                 MSM.horner_windows_plain(w, is_g2, bits))


@pytest.mark.parametrize("bits", [4, 2])
def test_horner_g1_four_msms(gen, bits):
    """M = 4, the dense path's stacked g1x4, at both radices."""
    w = [_rand_fq((4, MSM.WINDOWS[bits]), gen) for _ in range(3)]
    assert _same(MSM.horner_windows(w, False, bits),
                 MSM.horner_windows_plain(w, False, bits))


def _with_identities(p, is_g2, gen, share=0.1):
    """p with a random share of its points, window 1 of MSM 0 whole and
    the last MSM's last window whole, set to (0 : 1 : 0)."""
    ident = torch.rand(p[0].shape[ec.elem_axes(is_g2):], generator=gen,
                       device="cuda") < share
    ident[0, 1] = True
    ident[-1, -1] = True
    m = ident.view((1,) * ec.elem_axes(is_g2) + tuple(ident.shape))
    return [torch.where(m, i, c)
            for c, i in zip(p, ec.identity_like(p[0], is_g2))]


@pytest.mark.parametrize("variant", ["default", "per_thread", "staged",
                                     "windows"])
@pytest.mark.parametrize("L", [1, 2, 512])
@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_lane_fold_kernel_matches_plain(gen, is_g2, L, variant,
                                        monkeypatch):
    """M = 1-4 MSMs, W = 64 and 127 windows, identity lanes and windows;
    every level per thread (G1; G2 every level staged) over 2 blocks a
    window, every level staged over 8, several windows a block (3, 4 or
    2, the first that divides the M W windows) over 8 blocks a window
    with levels of more than 8 adds one a thread, and fold_plan's
    defaults."""
    if variant != "default":
        B0, K0, warps, wide = {"per_thread": (1, 2, 4, 0),
                               "staged": (1, 8, 16, 1 << 30),
                               "windows": (None, 8, 8, 8)}[variant]
        monkeypatch.setattr(MSM, "fold_plan", lambda G, L, g2, device: (
            B0 or next(b for b in (3, 4, 2, 1) if G % b == 0), min(K0, L),
            warps, wide))
    E = (2,) if is_g2 else ()
    for M, W in ((1, 64), (4, 127), (3, 64), (2, 127)):
        p = _with_identities([_rand_fq(E + (M, W, L), gen)
                              for _ in range(3)], is_g2, gen)
        assert _same(MSM.lane_fold(p, is_g2), MSM.lane_fold_plain(p, is_g2))


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_lane_fold_kernel_all_identity_and_bad_shapes(gen, is_g2):
    """All lanes at (0 : 1 : 0) fold to it; more than FOLD_MAX_LANES
    lanes or a lane count that is no power of two raise, no launch."""
    E = (2,) if is_g2 else ()
    ident = ec.identity_like(_rand_fq(E + (2, 64, 8), gen), is_g2)
    assert _same(MSM.lane_fold(ident, is_g2),
                 tuple(c[..., 0] for c in ident))
    before = MSM.FOLD[is_g2].launches
    for L in (2 * MSM.FOLD_MAX_LANES, 6):
        p = [_rand_fq(E + (1, 2, L), gen) for _ in range(3)]
        with pytest.raises(ValueError, match="power of two"):
            MSM.lane_fold(p, is_g2)
    assert MSM.FOLD[is_g2].launches == before


@pytest.mark.parametrize("C", [1, 5, 8, 64])
@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_chunk_carry_kernel_matches_plain(gen, is_g2, C):
    """The carry over C chunks' stacked partials at the 2^17 shapes and
    small ones: partials at infinity (a share, a whole window in every
    chunk, every partial of chunk 0 in the last MSM), each against the
    plain fold-half over the chunks; column counts with few factors of
    two (4 127 8 and 2: blocks of 32 and 2 columns).  Bad shapes and
    types raise, no launch."""
    E = (2,) if is_g2 else ()
    for M, W, T in ((3, 64, 128), (1, 64, 128), (4, 127, 8), (2, 1, 1)):
        if C == 64 and (M, W, T) == (3, 64, 128) and is_g2:
            continue   # G2 at 2^20 runs M = 1
        x, y = (_rand_fq((C,) + E + (M, W, T), gen).movedim(0, 1)
                .contiguous() for _ in "xy")
        inf = torch.rand((C, M, W, T), generator=gen, device="cuda") < 0.2
        inf[:, 0, 0] = True
        inf[0, -1] = True
        assert _same(CT.chunk_carry(x, y, inf, is_g2),
                     CT.chunk_carry_plain(x, y, inf, is_g2)), (M, W, T, C)
    before = CT.CARRY[is_g2].launches
    for bad in ((x[:, :4], y, inf), (x, y, inf.to(torch.uint8)),
                (x.to(torch.int64), y, inf), (x, y, inf[0])):
        with pytest.raises(ValueError, match="chunk_carry"):
            CT.chunk_carry(*bad, is_g2)
    assert CT.CARRY[is_g2].launches == before


@pytest.mark.parametrize("c", [4, 5, 8])
@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_kernels_match_plain(gen, is_g2, c):
    """The table and the fixed-base MSM against their plain versions
    (bit for bit) and the host's scalar multiplication, on edge scalars
    (0, 1, R - 1, the top window, zero windows) and random ones; one
    launch a call."""
    base = ec.points_to_device([G2_GEN if is_g2 else G1_GEN], is_g2, "cuda")
    before = FB.TABLE[is_g2].launches, FB.MSM[is_g2].launches
    tab = FB.fixed_base_table(base, c, is_g2)
    assert _same(tab, FB.fixed_base_table_plain(base, c, is_g2))
    rng = random.Random(c)
    scs = [0, 1, 2, R - 1, (1 << 253) + 1, (5 << 200) | 7] + [
        rng.randrange(R) for _ in range(1000)]
    sc = torch.from_numpy(F.ints_to_limbs(scs).astype(np.int32)).cuda()
    out = FB.fixed_base_msm(tab, sc, c, is_g2)
    assert _same(out, FB.fixed_base_msm_plain(tab, sc, c, is_g2))
    assert (FB.TABLE[is_g2].launches, FB.MSM[is_g2].launches) == (
        before[0] + 1, before[1] + 1)
    get = ec.g2_points_from_device if is_g2 else ec.g1_points_from_device
    mul, g = (g2_mul, G2_GEN) if is_g2 else (g1_mul, G1_GEN)
    got = get(*(o[..., :12].contiguous() for o in out))
    assert got == [mul(g, s) for s in scs[:12]]


def test_fixed_base_wrappers_refuse_bad_arguments(gen):
    """Bad window, shapes, dtype or devices raise before any launch."""
    base = ec.points_to_device([G1_GEN], False, "cuda")
    tab = FB.fixed_base_table(base, 8, False)
    sc = torch.ones((16, 4), dtype=torch.int32, device="cuda")
    launches = FB.TABLE[False].launches, FB.MSM[False].launches
    for bad in (lambda: FB.fixed_base_table(base, 17, False),
                lambda: FB.fixed_base_table(base, 8, True),
                lambda: FB.fixed_base_msm(tab, sc, 5, False),
                lambda: FB.fixed_base_msm(tab, sc.long(), 8, False),
                lambda: FB.fixed_base_msm(tab, sc[:8], 8, False),
                lambda: FB.fixed_base_msm(tab, sc.cpu(), 8, False)):
        with pytest.raises(ValueError):
            bad()
    assert (FB.TABLE[False].launches, FB.MSM[False].launches) == launches
    empty = FB.fixed_base_msm(tab, sc[:, :0], 8, False)
    assert empty[0].shape == (8, 0) and FB.MSM[False].launches == launches[1]
