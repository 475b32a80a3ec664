"""Fixed-base scalar multiplication: s_i * G for a vector of scalars and
one generator, the trusted setup's pk-query builder.

The reference's za_tpu/engine/msm.py ``fixed_base_table`` (with
``generator_doubles``) and ``fixed_base_msm``, XLA code there; kernels
of ``csrc/fixed_base.cu`` here, each with its plain version.  A wrapper
runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.

* ``fixed_base_table(base, c, is_g2)``: T[w, d] = d 2^(c w) G for
  w < W = ceil(254 / c) and d < 2^c, entry w 2^c + d of (8[,2], W 2^c)
  projective Montgomery l32 coordinates: ``fixed_base_windows`` of
  ``fixed_base_ladder``.
* ``fixed_base_ladder(base, c, is_g2)``: the doubling ladder D_i = 2^i G,
  D_0 .. D_(n-1) with n = min(c W, 255), the reference's
  generator_doubles (a bit of d past D_254 adds nothing); on the card
  one warp walks it.
* ``fixed_base_windows(ladder, c, is_g2)``: the table from the ladder;
  on the card by levels of the top bit k of d (T[w, d] = T[w, d - 2^k]
  + D_(c w + k)), the launches of ``level_launches(c)``.
* ``fixed_base_msm(table, scalars, c, is_g2)``: scalars (16, n) int32
  plain 16-bit limbs below 2^254 -> projective (8[,2], n): the sum over
  windows of T[w, digit_w], the unsigned c-bit digits.

Both take each entry's or scalar's adds in one order, the kernel and the
plain version alike: the first nonzero term copied, each later one added
with the complete add (``ec.point_add``), a zero digit skipped.  Their
coordinates are therefore equal bit for bit; against the reference,
which adds the identity where these copy or skip, the points are equal
after normalization.
"""

from __future__ import annotations

import torch

from . import ec, field as F
from ._build import kernel

SCALAR_BITS = 254
LADDER = SCALAR_BITS + 1     # D_0 .. D_254
MAX_WINDOW = 16              # a digit spans at most two 16-bit limbs

# levels 0 .. BLOCK_LEVELS - 1 of a window run in one launch (csrc/
# fixed_base.cu FB_BLOCK_LEVELS), each level above in one of its own
BLOCK_LEVELS = 5

LADDER_KERNEL = {
    False: kernel("fixed_base_ladder_g1", "fixed_base", "ppppppi"),
    True: kernel("fixed_base_ladder_g2", "fixed_base", "ppppppi")}
LEVELS_KERNEL = {
    False: kernel("fixed_base_levels_g1", "fixed_base", "ppppppiiii"),
    True: kernel("fixed_base_levels_g2", "fixed_base", "ppppppiiii")}
MSM = {False: kernel("fixed_base_msm_g1", "fixed_base", "pppppppiii"),
       True: kernel("fixed_base_msm_g2", "fixed_base", "pppppppiii")}


def windows(c: int) -> int:
    """Windows of c bits that cover a scalar below 2^254."""
    return -(-SCALAR_BITS // c)


def ladder_points(c: int) -> int:
    """The ladder's points for windows of c bits, D_0 .. D_(n-1)."""
    return min(windows(c) * c, LADDER)


def level_launches(c: int) -> list:
    """The window levels' launches, (k0, k1) each: levels 0 ..
    BLOCK_LEVELS - 1 in one, then each level above alone."""
    return [(0, min(c, BLOCK_LEVELS))] + [
        (k, k + 1) for k in range(BLOCK_LEVELS, c)]


def _check_window(c: int) -> None:
    if not 1 <= c <= MAX_WINDOW:
        raise ValueError(f"fixed_base: window {c} bits, want 1-{MAX_WINDOW}")


def digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(16, n) plain 16-bit limbs -> (W, n) int64 unsigned c-bit digits,
    window w holding bits [c w, c w + c) (the reference's
    digits_from_limbs)."""
    s = scalars.to(torch.int64)
    pad = torch.cat([s, torch.zeros_like(s[:2])])
    out = []
    for w in range(windows(c)):
        j, sh = divmod(c * w, 16)
        v = (pad[j] >> sh) | (pad[j + 1] << (16 - sh))
        out.append(v & ((1 << c) - 1))
    return torch.stack(out)


def _identity(like: torch.Tensor, fld):
    """(0 : 1 : 0) in l16, shaped like ``like``."""
    zero = torch.zeros_like(like)
    return zero, fld.one_like(like).clone(), zero.clone()


def _accumulate(acc, empty, take, pick, fld):
    """acc += the points pick(cols) at the columns where take: copied
    where acc is still empty, else added with the complete add; only
    those columns are computed -> (acc, empty)."""
    for cols, fresh in ((take & ~empty, False), (take & empty, True)):
        if not bool(cols.any()):
            continue
        idx = cols.nonzero().squeeze(1)
        pts = pick(idx)
        if not fresh:
            pts = ec.point_add(tuple(a[..., idx] for a in acc), pts, fld)
        acc = tuple(a.index_copy(a.dim() - 1, idx, p)
                    for a, p in zip(acc, pts))
    return acc, empty & ~take


def fixed_base_ladder_plain(base, c: int, is_g2: bool):
    fld = ec.field_of(is_g2)
    pts = [tuple(F.unpack(x) for x in base)]
    for _ in range(ladder_points(c) - 1):
        pts.append(ec.point_add(pts[-1], pts[-1], fld))
    return tuple(F.pack(torch.cat([p[k] for p in pts], -1))
                 for k in range(3))


def fixed_base_windows_plain(ladder, c: int, is_g2: bool):
    """Each entry's bits, low first, into its sum: the first copied."""
    fld = ec.field_of(is_g2)
    W, B = windows(c), 1 << c
    lad = tuple(F.unpack(x) for x in ladder)
    n = lad[0].shape[-1]
    d = torch.arange(B, device=lad[0].device).repeat(W)
    first = c * torch.arange(W, device=d.device).repeat_interleave(B)
    acc = _identity(torch.zeros_like(lad[0][..., :1]).expand(
        tuple(lad[0].shape[:-1]) + (W * B,)), fld)
    empty = torch.ones(W * B, dtype=torch.bool, device=d.device)
    for j in range(c):
        idx = first + j
        bit = (((d >> j) & 1) == 1) & (idx < n)
        acc, empty = _accumulate(
            acc, empty, bit, lambda i: tuple(p[..., idx[i]] for p in lad),
            fld)
    return tuple(F.pack(x) for x in acc)


def fixed_base_table_plain(base, c: int, is_g2: bool):
    return fixed_base_windows_plain(fixed_base_ladder_plain(base, c, is_g2),
                                    c, is_g2)


def fixed_base_msm_plain(table, scalars: torch.Tensor, c: int,
                         is_g2: bool):
    fld = ec.field_of(is_g2)
    B = 1 << c
    tab = tuple(F.unpack(x) for x in table)
    dig = digits(scalars, c)
    n = scalars.shape[1]
    acc = _identity(torch.zeros_like(tab[0][..., :1]).expand(
        tuple(tab[0].shape[:-1]) + (n,)), fld)
    empty = torch.ones(n, dtype=torch.bool, device=scalars.device)
    for w in range(dig.shape[0]):
        e = w * B + dig[w]
        acc, empty = _accumulate(
            acc, empty, dig[w] != 0,
            lambda i: tuple(t[..., e[i]] for t in tab), fld)
    return tuple(F.pack(x) for x in acc)


def _coords(pts, is_g2: bool, n: int | None, what: str):
    """Check projective l32 coordinates (8[,2], n) -> them, contiguous."""
    lead = (F.NL32, 2) if is_g2 else (F.NL32,)
    out = []
    for x in pts:
        if (x.dtype != torch.int32 or x.dim() != len(lead) + 1
                or tuple(x.shape[:-1]) != lead
                or (n is not None and x.shape[-1] != n)):
            raise ValueError(
                f"fixed_base: {what} must be int32 {lead + (n or 'n',)}, "
                f"got {x.dtype} {tuple(x.shape)}")
        out.append(x.contiguous())
    if len({x.device for x in out}) != 1:
        raise ValueError(f"fixed_base: {what} on one device")
    return out


def fixed_base_ladder(base, c: int, is_g2: bool):
    """base: G as projective (X, Y, Z), each (8[,2], 1) -> the ladder
    (X, Y, Z), each (8[,2], ladder_points(c))."""
    _check_window(c)
    ins = _coords(base, is_g2, 1, "the base point")
    if ins[0].device.type == "cpu":
        return fixed_base_ladder_plain(ins, c, is_g2)
    n = ladder_points(c)
    outs = [torch.empty(tuple(ins[0].shape[:-1]) + (n,), dtype=torch.int32,
                        device=ins[0].device) for _ in range(3)]
    LADDER_KERNEL[is_g2](*ins, *outs, n)
    return tuple(outs)


def fixed_base_windows(ladder, c: int, is_g2: bool):
    """ladder: fixed_base_ladder's for the same c -> the table (X, Y, Z),
    each (8[,2], W 2^c)."""
    _check_window(c)
    lad = _coords(ladder, is_g2, ladder_points(c), "the ladder")
    if lad[0].device.type == "cpu":
        return fixed_base_windows_plain(lad, c, is_g2)
    W = windows(c)
    outs = [torch.empty(tuple(lad[0].shape[:-1]) + (W << c,),
                        dtype=torch.int32, device=lad[0].device)
            for _ in range(3)]
    for k0, k1 in level_launches(c):
        LEVELS_KERNEL[is_g2](*lad, *outs, c, W, k0, k1)
    return tuple(outs)


def fixed_base_table(base, c: int, is_g2: bool):
    """base: G as projective (X, Y, Z), each (8[,2], 1) -> the table
    (X, Y, Z), each (8[,2], W 2^c)."""
    return fixed_base_windows(fixed_base_ladder(base, c, is_g2), c, is_g2)


def fixed_base_msm(table, scalars: torch.Tensor, c: int, is_g2: bool):
    """table: fixed_base_table's for the same c; scalars: (16, n) int32
    plain 16-bit limbs below 2^254 -> projective (X, Y, Z), each
    (8[,2], n), Z = 0 where the scalar is 0."""
    _check_window(c)
    tab = _coords(table, is_g2, windows(c) << c, "the table")
    if (scalars.dtype != torch.int32 or scalars.dim() != 2
            or scalars.shape[0] != F.NLIMBS):
        raise ValueError(f"fixed_base_msm: scalars must be int32 (16, n), "
                         f"got {scalars.dtype} {tuple(scalars.shape)}")
    if scalars.device != tab[0].device:
        raise ValueError("fixed_base_msm: table and scalars on one device")
    if scalars.device.type == "cpu":
        return fixed_base_msm_plain(tab, scalars, c, is_g2)
    scalars = scalars.contiguous()
    n = scalars.shape[1]
    outs = [torch.empty(tuple(tab[0].shape[:-1]) + (n,), dtype=torch.int32,
                        device=scalars.device) for _ in range(3)]
    if n:
        MSM[is_g2](*tab, scalars, *outs, n, c, windows(c))
    return tuple(outs)
