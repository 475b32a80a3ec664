"""Radix-2 NTT over Fr on the device, for the QAP quotient h(x).

The butterfly stages run on the ``ntt_stage_fr`` kernel of
csrc/ntt.cu (one launch per stage, batched over leading axes so the
three R1CS legs transform together); the bit reversal, the coset and
1/n scalings are tensor code over ``engine.field`` (l16 Montgomery
limbs).  Twiddle and coset tables are built on the host once per
domain size as Montgomery constants.  Mirrors ``groth16.domain.Domain``
(the host golden model) and the reference's za_tpu/engine/ntt_rns.py
RnsDomain (intt, coset_ntt, coset_intt); unlike the reference, no
four-step split.
"""

from __future__ import annotations

import torch

from ..curve import R
from ..groth16.domain import Domain
from . import field as F
from ._build import kernel

FR = F.FR
NTT_STAGE = kernel("ntt_stage_fr", "ntt", "ppiii")


def _pow_list(base: int, count: int, scale: int = 1) -> list[int]:
    out = []
    acc = scale % R
    for _ in range(count):
        out.append(acc)
        acc = acc * base % R
    return out


def _mont_table(vals, device) -> torch.Tensor:
    """Fr ints -> (16, n) int64 l16 Montgomery constants."""
    limbs = F.ints_to_limbs([FR.to_mont_int(v) for v in vals])
    return torch.from_numpy(limbs.astype("int64")).to(device)


def _bitrev(n: int) -> list[int]:
    k = n.bit_length() - 1
    return [int(format(i, f"0{k}b")[::-1], 2) if k else 0 for i in range(n)]


class DeviceDomain:
    """Twiddle and scaling tables of a 2^k domain on ``device``."""

    def __init__(self, size: int, device):
        self.size = size
        self.host = h = Domain(size)
        half = max(size // 2, 1)
        self.w_fwd = F.pack(_mont_table(_pow_list(h.omega, half), device))
        self.w_inv = F.pack(_mont_table(_pow_list(h.omega_inv, half),
                                        device))
        self.size_inv = _mont_table([h.size_inv], device)
        self.coset_pow = _mont_table(_pow_list(h.coset_gen, size), device)
        # inverse coset scaling with 1/n folded in
        self.coset_inv_pow = _mont_table(
            _pow_list(h.coset_gen_inv, size, scale=h.size_inv), device)
        self.z_coset_inv = _mont_table([h.z_coset_inv], device)
        self.bitrev = torch.tensor(_bitrev(size), dtype=torch.int64,
                                   device=device)


def ntt_stages_plain(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """All DIT stages over the last axis of bit-reversed l32 values
    (8, ..., n) with l32 twiddles tw (8, n/2)."""
    n = x.shape[-1]
    table = F.unpack(tw)
    v = F.unpack(x)
    lead = tuple(v.shape[:-1])
    length = 2
    while length <= n:
        half = length // 2
        twb = table[:, ::n // length][:, :half].reshape(
            (F.NLIMBS,) + (1,) * len(lead) + (half,))
        vr = v.reshape(lead + (n // length, length))
        vt = FR.mul(vr[..., half:], twb)
        v = torch.cat([FR.add(vr[..., :half], vt),
                       FR.sub(vr[..., :half], vt)], dim=-1).reshape(
            lead + (n,))
        length *= 2
    return F.pack(v)


def ntt_stages(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The stage kernel, launched log2(n) times on a copy of x."""
    if x.device.type == "cpu":
        return ntt_stages_plain(x, tw)
    n = x.shape[-1]
    if (x.dtype != torch.int32 or tw.dtype != torch.int32
            or tw.shape != (8, n // 2) or n & (n - 1)):
        raise ValueError("ntt_stages: int32 (8, ..., 2^k) values and "
                         "(8, 2^(k-1)) twiddles")
    y = x.reshape(8, -1, n).clone()
    tw = tw.contiguous()
    h = 1
    while h < n:
        NTT_STAGE(y, tw, y.shape[1], n, h)
        h *= 2
    return y.view(x.shape)


def _core(dom: DeviceDomain, x: torch.Tensor, table: torch.Tensor):
    """Radix-2 DIT NTT along the last axis of l16 (16, ..., n)
    Montgomery values (natural order in and out)."""
    x32 = F.pack(x).index_select(-1, dom.bitrev)
    return F.unpack(ntt_stages(x32, table))


def _scale(x, table):
    """Elementwise product with a (16, n) table (or (16, 1) constant)."""
    return FR.mul(x, table.view((F.NLIMBS,) + (1,) * (x.dim() - 2)
                                + (table.shape[-1],)))


def ntt(dom: DeviceDomain, coeffs):
    return _core(dom, coeffs, dom.w_fwd)


def intt(dom: DeviceDomain, evals):
    return _scale(_core(dom, evals, dom.w_inv), dom.size_inv)


def coset_ntt(dom: DeviceDomain, coeffs):
    return _core(dom, _scale(coeffs, dom.coset_pow), dom.w_fwd)


def coset_intt(dom: DeviceDomain, evals):
    return _scale(_core(dom, evals, dom.w_inv), dom.coset_inv_pow)
