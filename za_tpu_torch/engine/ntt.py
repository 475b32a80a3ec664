"""The NTT over Fr on the device, for the QAP quotient h(x).

Domains of ``FOURSTEP_MIN = 2^12`` and up take the four-step split of
the reference (za_tpu/engine/ntt_rns.py _fourstep_core, RnsFourStep):
n = n1 n2, the values viewed as (n2, n1), a sub-NTT of length n2 over
each of the n1 lane columns, the inter-factor twiddles w^(k2 j1) with a
transpose to (n1, n2), and a sub-NTT of length n1 over each of the n2
columns; the result is in natural order.  Each sub-NTT runs its bit
reversal and first log2(m_fuse) stages in one ``ntt_prefix_fr`` launch
(the port of the reference's fused Pallas prefix, pallas_ntt.py
sub_ntt_fused), any stages above m_fuse in ``ntt_stage_fr``; the
twiddle multiply and transpose is ``ntt_twiddle_fr`` (csrc/ntt.cu).
The route depends on the size alone, so the CPU runs it too, through
the plain versions.

Smaller domains take the radix-2 transform, a sub-NTT of one lane: a
bit-reversal gather, then one ``ntt_stage_fr`` launch per stage.  The
coset and 1/n scalings are tensor code over ``engine.field`` (l16
Montgomery limbs); in the four-step the inverse twiddles hold 1/n.
Tables are built on the host once per domain size.  Mirrors
``groth16.domain.Domain``, the host golden model.
"""

from __future__ import annotations

import functools

import torch

from ..curve import R
from ..groth16.domain import Domain
from . import field as F
from ._build import kernel

FR = F.FR
NTT_STAGE = kernel("ntt_stage_fr", "ntt", "ppiiii")
NTT_PREFIX = kernel("ntt_prefix_fr", "ntt", "pppiiii")
NTT_TWIDDLE = kernel("ntt_twiddle_fr", "ntt", "pppiii")

#: domains at least this large take the four-step (the reference's
#: FOURSTEP_MIN, ntt_rns.py)
FOURSTEP_MIN = 1 << 12

#: lanes of one ntt_prefix_fr block: PREFIX_LANES in csrc/ntt.cu, which
#: a test holds equal to this one
PREFIX_LANES = 8

#: shared memory of one ntt_prefix_fr block: m_fuse rows x PREFIX_LANES
#: lanes x 32 B.  128 KB fuses every stage of a 512-row sub-NTT (2^18).
PREFIX_SMEM_BYTES = 128 * 1024


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


def _twiddles(base: int, count: int, device) -> torch.Tensor:
    """(8, count) l32 Montgomery table of base^k."""
    return F.pack(_mont_table(_pow_list(base, max(count, 1)), device))


@functools.lru_cache(maxsize=None)
def _bitrev_index(n: int, device: torch.device) -> torch.Tensor:
    """The bit-reversal permutation of n rows, uploaded once per device."""
    k = n.bit_length() - 1
    return torch.tensor([int(format(i, f"0{k}b")[::-1], 2) if k else 0
                         for i in range(n)], device=device)


class FourStepTables:
    """Four-step tables of a 2^k domain (the reference's RnsFourStep):
    n1 = 2^ceil(k/2), n2 = n / n1; sub-NTT twiddles t1 (n1/2) and t2
    (n2/2); inter[k2, j1] = w^(k2 j1), the inverse's with 1/n folded in;
    all l32 Montgomery, inter (8, n2, n1)."""

    def __init__(self, host: Domain, device):
        k = host.k
        self.n1 = n1 = 1 << ((k + 1) // 2)
        self.n2 = n2 = host.size // n1
        sub1, sub2 = Domain(n1), Domain(n2)
        self.t1_fwd = _twiddles(sub1.omega, n1 // 2, device)
        self.t1_inv = _twiddles(sub1.omega_inv, n1 // 2, device)
        self.t2_fwd = _twiddles(sub2.omega, n2 // 2, device)
        self.t2_inv = _twiddles(sub2.omega_inv, n2 // 2, device)
        self.inter_fwd = self._inter(host.omega, 1, device)
        self.inter_inv = self._inter(host.omega_inv, host.size_inv, device)

    def _inter(self, w: int, scale: int, device) -> torch.Tensor:
        vals, wk = [], 1
        for _ in range(self.n2):      # row k2: scale * (w^k2)^j1
            vals += _pow_list(wk, self.n1, scale)
            wk = wk * w % R
        return F.pack(_mont_table(vals, device)).reshape(
            F.NL32, self.n2, self.n1)

    def tables(self, inverse: bool):
        """(t2, t1, inter) of the forward or the inverse transform."""
        if inverse:
            return self.t2_inv, self.t1_inv, self.inter_inv
        return self.t2_fwd, self.t1_fwd, self.inter_fwd


class DeviceDomain:
    """Twiddle and scaling tables of a 2^k domain on ``device``:
    four-step tables from FOURSTEP_MIN up, radix-2 ones below."""

    def __init__(self, size: int, device):
        self.size = size
        self.host = h = Domain(size)
        self.coset_pow = _mont_table(_pow_list(h.coset_gen, size), device)
        self.z_coset_inv = _mont_table([h.z_coset_inv], device)
        if size >= FOURSTEP_MIN:
            self.fourstep = FourStepTables(h, device)
            # the four-step inverse folds 1/n into its inter twiddles
            self.coset_inv_nofold = _mont_table(
                _pow_list(h.coset_gen_inv, size), device)
            return
        self.fourstep = None
        self.w_fwd = _twiddles(h.omega, size // 2, device)
        self.w_inv = _twiddles(h.omega_inv, size // 2, device)
        self.size_inv = _mont_table([h.size_inv], device)
        # inverse coset scaling with 1/n folded in
        self.coset_inv_pow = _mont_table(
            _pow_list(h.coset_gen_inv, size, scale=h.size_inv), device)


# -- the three kernels and their plain versions ------------------------------
#
# Sub-NTT batches are l32 (8, B, S, L): B transforms of length S along
# axis 2, each over L lane columns; twiddle tables (8, S/2) hold w^k.


def _stages16(v: torch.Tensor, table: torch.Tensor, first: int,
              last: int) -> torch.Tensor:
    """DIT stages of lengths first..last along axis 2 of l16
    (16, B, S, L), with l16 twiddles table (16, S/2)."""
    _, B, S, L = v.shape
    length = first
    while length <= last:
        half = length // 2
        twb = table[:, ::S // length][:, :half].reshape(
            F.NLIMBS, 1, 1, half, 1)
        vr = v.reshape(F.NLIMBS, B, S // length, length, L)
        vt = FR.mul(vr[:, :, :, half:], twb)
        v = torch.cat([FR.add(vr[:, :, :, :half], vt),
                       FR.sub(vr[:, :, :, :half], vt)], dim=3).reshape(
            F.NLIMBS, B, S, L)
        length *= 2
    return v


def _bitrev_rows(x: torch.Tensor) -> torch.Tensor:
    return x.index_select(2, _bitrev_index(x.shape[2], x.device))


def ntt_stages_plain(x: torch.Tensor, tw: torch.Tensor,
                     start: int = 2) -> torch.Tensor:
    """DIT stages of lengths start..S along axis 2 of l32 (8, B, S, L)
    whose rows are in bit-reversed order (the earlier stages done)."""
    S = x.shape[2]
    return F.pack(_stages16(F.unpack(x), F.unpack(tw), start, S))


def ntt_stages(x: torch.Tensor, tw: torch.Tensor,
               start: int = 2) -> torch.Tensor:
    """The stage kernel, launched once per stage on a copy of x."""
    if x.device.type == "cpu":
        return ntt_stages_plain(x, tw, start)
    _, B, S, L = x.shape
    if (x.dtype != torch.int32 or tw.dtype != torch.int32
            or tw.shape != (8, S // 2) or S & (S - 1)
            or start & (start - 1) or start < 2):
        raise ValueError("ntt_stages: int32 (8, B, 2^k, L) values, "
                         "(8, 2^(k-1)) twiddles, a power-of-two start")
    y = x.contiguous().clone()
    tw = tw.contiguous()
    h = start // 2
    while h < S:
        NTT_STAGE(y, tw, B, S, L, h)
        h *= 2
    return y


def prefix_rows(S: int, L: int) -> int:
    """m_fuse: the largest power of two <= S whose m_fuse rows x
    PREFIX_LANES lanes fit PREFIX_SMEM_BYTES (the reference's
    pick_m_fuse); 1 where L is no multiple of the kernel's lane tile."""
    if L % PREFIX_LANES:
        return 1
    m = S
    while m > 1 and m * PREFIX_LANES * 32 > PREFIX_SMEM_BYTES:
        m //= 2
    return m


def ntt_prefix_plain(x: torch.Tensor, tw: torch.Tensor,
                     m: int) -> torch.Tensor:
    """Bit reversal along axis 2 of l32 (8, B, S, L), then the DIT
    stages of lengths 2..m."""
    return F.pack(_stages16(F.unpack(_bitrev_rows(x)), F.unpack(tw), 2, m))


def ntt_prefix(x: torch.Tensor, tw: torch.Tensor, m: int) -> torch.Tensor:
    """The prefix kernel, out of place."""
    if x.device.type == "cpu":
        return ntt_prefix_plain(x, tw, m)
    _, B, S, L = x.shape
    if (x.dtype != torch.int32 or tw.dtype != torch.int32
            or tw.shape != (8, S // 2) or S & (S - 1) or m & (m - 1)
            or not 2 <= m <= S or L % PREFIX_LANES):
        raise ValueError(f"ntt_prefix: int32 (8, B, 2^k, L) values with L "
                         f"a multiple of {PREFIX_LANES}, (8, 2^(k-1)) "
                         f"twiddles, 2 <= m <= 2^k a power of two")
    x = x.contiguous()
    y = torch.empty_like(x)
    NTT_PREFIX(x, y, tw.contiguous(), B, S, L, m)
    return y


def ntt_twiddle_plain(a: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
    """out[:, b, c, r] = a[:, b, r, c] * inter[:, r, c]: l32 (8, B, R, C)
    and (8, R, C) -> (8, B, C, R)."""
    prod = FR.mul(F.unpack(a), F.unpack(inter).unsqueeze(1))
    return F.pack(prod.transpose(2, 3)).contiguous()


def ntt_twiddle(a: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
    """The twiddle-transpose kernel."""
    if a.device.type == "cpu":
        return ntt_twiddle_plain(a, inter)
    _, B, Rr, C = a.shape
    if (a.dtype != torch.int32 or inter.dtype != torch.int32
            or inter.shape != (8, Rr, C)):
        raise ValueError("ntt_twiddle: int32 (8, B, R, C) values and "
                         "(8, R, C) twiddles")
    a = a.contiguous()
    out = torch.empty((8, B, C, Rr), dtype=torch.int32, device=a.device)
    NTT_TWIDDLE(a, inter.contiguous(), out, B, Rr, C)
    return out


# -- the four-step -------------------------------------------------------------


def _sub_ntt(x, table, S, prefix, stages):
    m = prefix_rows(S, x.shape[3])
    if m < 4:   # nothing worth fusing at this shape
        return stages(_bitrev_rows(x), table, 2)
    y = prefix(x, table, m)
    return y if m == S else stages(y, table, 2 * m)


def sub_ntt(x: torch.Tensor, table: torch.Tensor, S: int) -> torch.Tensor:
    """Radix-2 DIT NTT along axis 2 of l32 (8, B, S, L), natural order
    in and out: the bit reversal and stages 2..m_fuse in the prefix
    kernel, the stages 2 m_fuse..S in the stage kernel."""
    return _sub_ntt(x, table, S, ntt_prefix, ntt_stages)


def sub_ntt_plain(x: torch.Tensor, table: torch.Tensor,
                  S: int) -> torch.Tensor:
    return _sub_ntt(x, table, S, ntt_prefix_plain, ntt_stages_plain)


def fourstep_core(x: torch.Tensor, t2, t1, inter, n1: int,
                  n2: int) -> torch.Tensor:
    """l32 (8, B, n) natural order -> (8, B, n) natural order."""
    B = x.shape[1]
    a = sub_ntt(x.reshape(F.NL32, B, n2, n1), t2, n2)  # over j2, lanes j1
    a = ntt_twiddle(a, inter)                           # (8, B, n1, n2)
    b = sub_ntt(a, t1, n1)                              # over j1, lanes k2
    return b.reshape(F.NL32, B, n1 * n2)                # [k1, k2]: natural


# -- transforms ----------------------------------------------------------------


def _core(dom: DeviceDomain, x: torch.Tensor, inverse: bool):
    """NTT along the last axis of l16 (16, ..., n) Montgomery values
    (natural order in and out), by w^-1 where inverse (and, four-step,
    times 1/n)."""
    x32 = F.pack(x)
    shape = x32.shape
    x32 = x32.reshape(F.NL32, -1, dom.size)
    fs = dom.fourstep
    if fs is not None:
        y = fourstep_core(x32, *fs.tables(inverse), fs.n1, fs.n2)
    else:   # radix-2: one sub-NTT over a single lane, nothing fused
        table = dom.w_inv if inverse else dom.w_fwd
        y = sub_ntt(x32.unsqueeze(-1), table, dom.size)
    return F.unpack(y.reshape(shape))


def _scale(x, table):
    """Elementwise product with a (16, n) table (or (16, 1) constant)."""
    return FR.mul(x, table.view((F.NLIMBS,) + (1,) * (x.dim() - 2)
                                + (table.shape[-1],)))


def ntt(dom: DeviceDomain, coeffs):
    return _core(dom, coeffs, False)


def intt(dom: DeviceDomain, evals):
    x = _core(dom, evals, True)
    if dom.fourstep is not None:  # inter_inv holds 1/n
        return x
    return _scale(x, dom.size_inv)


def coset_ntt(dom: DeviceDomain, coeffs):
    return _core(dom, _scale(coeffs, dom.coset_pow), False)


def coset_intt(dom: DeviceDomain, evals):
    x = _core(dom, evals, True)
    if dom.fourstep is not None:
        return _scale(x, dom.coset_inv_nofold)
    return _scale(x, dom.coset_inv_pow)
