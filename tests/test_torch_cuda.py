"""On an NVIDIA card: every CUDA kernel of the port against its plain
PyTorch version on the same inputs, exact equality.  Skips without a
card (the full-width comparison is chip_smoke.py's)."""

import pytest
import torch

from za_tpu_torch.engine import cuda_tree as CT, ec, field as F
from za_tpu_torch.engine import msm as MSM, msm_dense as MD
from za_tpu_torch.engine import msm_tree as MT, ntt as NTT

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


def test_ntt_stage_kernel_matches_plain(gen):
    dom = NTT.DeviceDomain(1 << 10, "cuda")
    x = _rand_fq((3, 1 << 10), gen)   # top limb < 0x3064: canonical mod r
    assert torch.equal(NTT.ntt_stages(x, dom.w_fwd),
                       NTT.ntt_stages_plain(x, dom.w_fwd))


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
