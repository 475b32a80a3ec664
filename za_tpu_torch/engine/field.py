"""BN254 Fq / Fr / Fq2 arithmetic on torch tensors.

Layouts:

* Kernel boundary ("l32"): a field element is a canonical value in
  [0, p) in Montgomery form (R = 2^256), stored as eight 32-bit limbs,
  little-endian, limb-major: an int32 tensor ``(8, ...)`` holding the
  u32 bit patterns, so that thread i of a kernel reads limb j of
  element i at a coalesced address.  Fq2 adds a component axis right
  after the limbs: ``(8, 2, ...)``.
* Plain versions ("l16"): sixteen 16-bit limbs held in int64,
  ``(16, ...)``, so every limb product (< 2^32) and every column sum of
  a 16x16 schoolbook product (< 2^37) fits.  Every op takes and returns
  canonical values.
* Host <-> device: ``(16, n)`` 16-bit plain (non-Montgomery) limbs, the
  layout of the reference's raw pk queries and witness arrays.  A
  witness list crosses as rows instead, ``(n, 8)`` int32, value j's
  eight 32-bit limbs in row j (``witness_rows``, 32 B a value), widened
  to ``(16, n)`` on the device (``rows_to_limbs``).

The CUDA side of the same arithmetic is ``csrc/field.cuh``; the
functions here are its plain versions and the tensor code of the paths
that are not kernels yet (NTT, matvec).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..curve import Q, R
from ..native import witness_lib
from . import metrics as MET

NLIMBS = 16        # 16-bit limbs of the host layout and the plain versions
NL32 = 8           # 32-bit limbs at kernel boundaries
MASK = 0xFFFF
I64 = torch.int64


# -- host conversions ---------------------------------------------------------


def ints_to_limbs(vs) -> np.ndarray:
    """list of ints (< 2^256) -> (16, n) uint32 16-bit limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vs)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(vs), NLIMBS)
    return np.ascontiguousarray(arr.T).astype(np.uint32)


def witness_rows(z, rows: torch.Tensor,
                 digits: bool = False) -> tuple[int, int | None]:
    """z (a list or tuple of n witness values) -> rows, an (n, 8) int32
    host tensor: row j the eight little-endian 32-bit limbs of z[j] mod R,
    in one native pass (``native/witness_limbs.c``; ``witness_lib()`` must
    not be None).  Equal to ``ints_to_limbs([v % R for v in z])`` once
    widened; raises what that raises.  -> the number of values that took
    the native pass's Python fallback (not an exact int in [0, 2^256)),
    and with ``digits`` the values' nonzero 4-bit digits (``limb_digits``'s
    count; the same pass counts them), else None."""
    if (rows.device.type != "cpu" or rows.dtype != torch.int32
            or tuple(rows.shape) != (len(z), NL32)
            or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous ({len(z)}, {NL32}) "
                         f"int32 host tensor, not {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    live = ctypes.c_longlong() if digits else None
    fallback = witness_lib().za_witness_rows(
        z, rows.data_ptr(), len(z), R,
        None if live is None else ctypes.byref(live))
    return fallback, None if live is None else live.value


def limb_digits(limbs: np.ndarray) -> int:
    """The nonzero 4-bit digits of (16, n) 16-bit limbs: of each value's
    64 digit slots, those the MSM's windows find nonzero before their
    signed recoding."""
    return sum(int(np.count_nonzero((limbs >> s) & 0xF))
               for s in (0, 4, 8, 12))


def rows_to_limbs(rows: torch.Tensor) -> torch.Tensor:
    """(n, 8) int32 rows of 32-bit limbs -> (16, n) int32 16-bit limbs, on
    the rows' device: the int16 halves (limb 2k is word k's low half)
    widened in a transposing copy, then masked to 16 bits."""
    out = torch.empty((NLIMBS, rows.shape[0]), dtype=torch.int32,
                      device=rows.device)
    out.copy_(rows.view(torch.int16).t())
    return out.bitwise_and_(MASK)


def limbs_to_ints(a) -> list[int]:
    """(16, n) canonical 16-bit limbs -> list of n ints."""
    a = np.asarray(a)
    packed = a.astype("<u2").T.copy().tobytes()
    return [
        int.from_bytes(packed[j * 32:(j + 1) * 32], "little")
        for j in range(a.shape[1])
    ]


def ints_to_l32(vs) -> np.ndarray:
    """list of ints (< 2^256) -> (8, n) int32 (u32 bit patterns)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vs)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(vs), NL32)
    return np.ascontiguousarray(arr.T).view(np.int32)


def l32_to_ints(a) -> list[int]:
    """(8, n) int32 limb planes -> list of n ints."""
    a = np.ascontiguousarray(np.asarray(a).view(np.uint32).astype("<u4"))
    packed = a.T.copy().tobytes()
    return [
        int.from_bytes(packed[j * 32:(j + 1) * 32], "little")
        for j in range(a.shape[1])
    ]


# -- layout conversions on tensors ----------------------------------------------


def unpack(x32: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 -> (16, ...) int64 16-bit limbs."""
    v = x32.to(I64) & 0xFFFFFFFF
    return torch.stack([v & MASK, v >> 16], dim=1).reshape(
        (NLIMBS,) + tuple(x32.shape[1:])
    )


def pack(l16: torch.Tensor) -> torch.Tensor:
    """(16, ...) int64 16-bit limbs -> (8, ...) int32 (u32 bit patterns)."""
    v = l16[0::2] | (l16[1::2] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# -- prime fields ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _const(v: int, device: str) -> torch.Tensor:
    return MET.to_device(torch.tensor(
        [(v >> (16 * i)) & MASK for i in range(NLIMBS)], dtype=I64), device)


def _col(c: torch.Tensor, ndim: int) -> torch.Tensor:
    """(16,) constant -> (16, 1, ..., 1) against an ndim-dim operand."""
    return c.view((NLIMBS,) + (1,) * (ndim - 1))


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Carry/borrow propagation along the limb axis (in place): every
    limb but the last ends in [0, 2^16); the last absorbs the rest and
    carries the sign.  Arithmetic shifts make borrows exact."""
    for i in range(t.shape[0] - 1):
        c = t[i] >> 16
        t[i] &= MASK
        t[i + 1] += c
    return t


def _pick_reduced(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """v (16, ...) unnormalized limbs of a value in [0, 2p) -> canonical
    v mod p: both candidates normalized in one pass, then the sign of
    v - p picks."""
    cand = _normalize(torch.stack([v, v - _col(p, v.dim())], dim=-1))
    return torch.where(cand[-1, ..., 1:2] < 0, cand[..., 0:1],
                       cand[..., 1:2]).squeeze(-1)


class PrimeField:
    """Montgomery arithmetic mod p on l16 tensors (16, ...).  Element
    axes: the limb axis only (``ax`` is where mul_many stacks)."""

    nel = 1
    ax = 1

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.r_mod = (1 << 256) % modulus
        self.r2 = (1 << 512) % modulus
        self.np0 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)

    # host helpers
    def to_mont_int(self, v: int) -> int:
        return v * self.r_mod % self.modulus

    def from_mont_int(self, v: int) -> int:
        return v * pow(self.r_mod, -1, self.modulus) % self.modulus

    def const(self, v: int, like: torch.Tensor) -> torch.Tensor:
        """Canonical int constant as an l16 column against ``like``."""
        return _col(_const(v % self.modulus, str(like.device)), like.dim())

    def p_limbs(self, like: torch.Tensor) -> torch.Tensor:
        return _const(self.modulus, str(like.device))

    def one_like(self, x):
        return self.const(self.r_mod, x).expand_as(x)

    # arithmetic
    def add(self, a, b):
        s = a + b
        return _pick_reduced(s, self.p_limbs(s))

    def sub(self, a, b):
        d = a - b
        p = _col(self.p_limbs(d), d.dim())
        cand = _normalize(torch.stack([d, d + p], dim=-1))
        return torch.where(cand[-1, ..., 0:1] < 0, cand[..., 1:2],
                           cand[..., 0:1]).squeeze(-1)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def redc(self, t: torch.Tensor) -> torch.Tensor:
        """Montgomery reduction of 33 unnormalized columns (value <
        p * 2^256, columns < 2^37) -> canonical t / 2^256 mod p."""
        p = self.p_limbs(t)
        pc = _col(p, t.dim())
        for i in range(NLIMBS):
            m = ((t[i] & MASK) * self.np0) & MASK
            t[i:i + NLIMBS] += m * pc
            t[i + 1] += t[i] >> 16
        return _pick_reduced(t[NLIMBS:2 * NLIMBS], p)

    def mul(self, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        t = torch.zeros((2 * NLIMBS + 1,) + tuple(shape[1:]), dtype=I64,
                        device=a.device)
        for i in range(NLIMBS):
            t[i:i + NLIMBS] += a[i] * b
        return self.redc(t)

    def sqr(self, a):
        return self.mul(a, a)

    def pow(self, a, e: int):
        """a^e (Montgomery in and out), 4-bit windows MSB first."""
        tab = [self.one_like(a), a]
        for _ in range(14):
            tab.append(self.mul(tab[-1], a))
        digits = []
        while e:
            digits.append(e & 15)
            e >>= 4
        acc = tab[digits[-1]]
        for d in reversed(digits[:-1]):
            for _ in range(4):
                acc = self.sqr(acc)
            if d:
                acc = self.mul(acc, tab[d])
        return acc

    def inv(self, a):
        """Fermat inverse a^(p-2); maps 0 to 0."""
        return self.pow(a, self.modulus - 2)

    def to_mont(self, a):
        return self.mul(a, self.const(self.r2, a))

    def from_mont(self, a):
        return self.mul(a, self.const(1, a))

    def where(self, cond, a, b):
        """cond over the batch axes selects a or b."""
        return torch.where(cond.unsqueeze(0), a, b)

    # batched forms: independent ops stacked into one (as ec.point_add uses)
    def _many(self, op, pairs):
        shape = torch.broadcast_shapes(*[t.shape for pr in pairs for t in pr])
        A = torch.stack([a.expand(shape) for a, _ in pairs], dim=self.ax)
        B = torch.stack([b.expand(shape) for _, b in pairs], dim=self.ax)
        return op(A, B).unbind(self.ax)

    def mul_many(self, pairs):
        return self._many(self.mul, pairs)

    def add_many(self, pairs):
        return self._many(self.add, pairs)

    def sub_many(self, pairs):
        return self._many(self.sub, pairs)


class QuadField:
    """Fq2 = Fq[i]/(i^2 + 1) on l16 tensors (16, 2, ...): component axis
    right after the limbs."""

    nel = 2
    ax = 2

    def __init__(self, base: PrimeField):
        self.base = base
        self.modulus = base.modulus

    def const(self, c0: int, c1: int, like):
        b = self.base
        col = torch.stack(
            [_const(c0 % b.modulus, str(like.device)),
             _const(c1 % b.modulus, str(like.device))], dim=1)
        return col.view((NLIMBS, 2) + (1,) * (like.dim() - 2))

    def one_like(self, x):
        return self.const(self.base.r_mod, 0, x).expand_as(x)

    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        A = torch.stack([a[:, 0], a[:, 0], a[:, 1], a[:, 1]], dim=1)
        B = torch.stack([b[:, 0], b[:, 1], b[:, 0], b[:, 1]], dim=1)
        P = self.base.mul(A, B)
        c0 = self.base.sub(P[:, 0], P[:, 3])
        c1 = self.base.add(P[:, 1], P[:, 2])
        return torch.stack([c0, c1], dim=1)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """(a0 + a1 i)^-1 = (a0 - a1 i) / (a0^2 + a1^2); 0 -> 0."""
        f = self.base
        sq = f.mul(a, a)
        ninv = f.inv(f.add(sq[:, 0], sq[:, 1]))
        both = f.mul(a, ninv.unsqueeze(1))
        return torch.stack([both[:, 0], f.neg(both[:, 1])], dim=1)

    def where(self, cond, a, b):
        return torch.where(cond.unsqueeze(0).unsqueeze(0), a, b)

    _many = PrimeField._many

    def mul_many(self, pairs):
        return self._many(self.mul, pairs)

    def add_many(self, pairs):
        return self._many(self.add, pairs)

    def sub_many(self, pairs):
        return self._many(self.sub, pairs)


def batch_inv(fld, x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse (0 -> 0) of l16 values by a product tree: ~3
    multiplications per element in 2 log2(n) wide calls plus one Fermat
    inverse of the root (Montgomery's batch trick, vectorized)."""
    ne = fld.nel
    shape = x.shape
    v = x.reshape(tuple(shape[:ne]) + (-1,))
    n = v.shape[-1]
    zero = (v == 0).reshape(-1, n).all(dim=0)
    v = torch.where(zero, fld.one_like(v), v)
    size = 1 << max(n - 1, 0).bit_length()
    if size > n:
        v = torch.cat([v, fld.one_like(v[..., :1]).expand(
            tuple(v.shape[:-1]) + (size - n,))], dim=-1)
    levels = [v]
    while levels[-1].shape[-1] > 1:
        a = levels[-1]
        levels.append(fld.mul(a[..., 0::2], a[..., 1::2]))
    inv = fld.inv(levels[-1])
    for a in reversed(levels[:-1]):
        # inverse of a child = inverse of the parent * its sibling
        sib = torch.stack([a[..., 1::2], a[..., 0::2]], dim=-1)
        inv = fld.mul(inv.unsqueeze(-1), sib).reshape(a.shape)
    inv = torch.where(zero, torch.zeros_like(inv[..., :n]), inv[..., :n])
    return inv.reshape(shape)


FQ = PrimeField(Q)
FR = PrimeField(R)
FQ2 = QuadField(FQ)
