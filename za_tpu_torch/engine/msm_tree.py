"""Batch-affine tree MSM: staged tables, digit selection, and the plain
versions of the four tree-level kernels.

The algorithm is the reference's (za_tpu/engine/msm_tree.py and
pallas_tree.py):

* the {1P..8P} multiples of every point are built once at staging,
  normalized to affine and kept on the device (``AffineTables``);
* per window w and point i the signed radix-16 digit selects
  d * P_i from the table (d < 0 negates y, d = 0 is infinity);
* each window's selected points are summed by a binary tree of affine
  additions, pairing point i with i + n/2 (fold-half), where all the
  divisions of a level share inversions (batch inversion), ~6
  multiplications per add against 14 for complete projective adds;
* the last 128 partials per window go projective (chunk carry, lane
  fold, Horner: ``engine.msm``).

Two finite operands with equal x, which the reference excludes by
contract, are handled: P + P doubles and P + (-P) is infinity.  Sums of
repeated pk points reach them (a point in several query columns, a
pool key, a witness of bits), where the reference's shared inversion
would fail for a whole block.  Values are canonical, so there is no
bound bookkeeping (the reference's RNS offsets).

Layouts (l32, ``engine.field``; E = (8,) for G1, (8, 2) for G2):
  tables tx, ty: (C, 8, *E, M, S) int32; ident: (C, M, S) bool
  level state x, y: (*E, M, W, n) int32; inf: (M, W, n) bool
  digits: (W, M, S) int8 per chunk
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import ec, field as F

HALF = 8          # table entries {1P..8P}
WIN = 64


@dataclass
class AffineTables:
    """Staged MSM operand: affine multiple tables, chunked.

    tx, ty: (C, HALF, *E, M, S) int32 canonical Montgomery
    ident:  (C, M, S) bool -- identity input columns (pk queries carry
            infinity at non-dense slots).  Their table entries are
            (0, 0); the MSM zeroes these columns' digits so selection
            flags them at infinity whatever the scalar.
    n:      true (unpadded) point count per query"""

    tx: torch.Tensor
    ty: torch.Tensor
    ident: torch.Tensor
    n: int
    is_g2: bool

    @property
    def chunks(self) -> int:
        return self.tx.shape[0]

    @property
    def m(self) -> int:
        return self.tx.shape[-2]

    @property
    def chunk_cols(self) -> int:
        return self.tx.shape[-1]


# -- staging ----------------------------------------------------------------------


def build_tables_block(coords, is_g2: bool):
    """One column block of projective points -> affine tables.

    coords: (X, Y, Z) as Montgomery l32 int32 tensors (8, *C, N) with
    C = (2,) for G2.  Returns tx, ty (HALF, 8, *C, N) int32 and the
    identity mask (N,) bool (Z == 0)."""
    X, Y, Z = coords
    ne = ec.elem_axes(is_g2)
    ident = (Z == 0).reshape(-1, Z.shape[-1]).all(dim=0)
    pts = [(X, Y, Z)]
    for _ in range(HALF - 1):
        pts.append(ec.ec_add(pts[-1], pts[0], is_g2))
    # (*E, HALF, N): one normalisation pass over all eight multiples
    stk = [torch.stack([p[i] for p in pts], dim=ne) for i in range(3)]
    ax, ay = ec.to_affine(*stk, is_g2)
    return ax.movedim(ne, 0), ay.movedim(ne, 0), ident


def mask_ident_digits(d: torch.Tensor, ident: torch.Tensor) -> torch.Tensor:
    """Zero the digits of identity columns: d (C, W, M, S), ident
    (C, M, S) bool."""
    return torch.where(ident.unsqueeze(1), torch.zeros_like(d), d)


# -- selection and the plain tree levels -------------------------------------------


def select_tables(tabx, taby, d, is_g2: bool):
    """Digit selection from one chunk's tables.

    tabx, taby: (HALF, *E, M, S) int32; d (W, M, S) int8 -> x, y
    (*E, M, W, S) int32 and inf (M, W, S) bool.  d = 0 reads entry 0
    (and is flagged), as the level-0 kernels do."""
    fld = ec.field_of(is_g2)
    ne = ec.elem_axes(is_g2)
    dm = d.to(torch.int64).permute(1, 0, 2)               # (M, W, S)
    k = (dm.abs().clamp(min=1) - 1)
    idx = k.expand(tabx.shape[1:ne + 1] + k.shape)        # (*E, M, W, S)

    def pick(tab):
        t = tab.movedim(0, ne + 1)                        # (*E, M, HALF, S)
        return torch.gather(t, ne + 1, idx)

    sx = pick(tabx)
    sy = F.unpack(pick(taby))
    sy = fld.where(dm < 0, fld.neg(sy), sy)
    return sx, F.pack(sy), dm == 0


def affine_level(x1, y1, i1, x2, y2, i2, fld):
    """Affine add of operand pairs (l16 coordinates, bool flags) with
    the infinity rules; the denominators share one batch inversion.
    Finite operands with equal x: P + P doubles (den = 2 y1, lam = 3 x1^2
    / den), P + (-P) is infinity (den = 1, then x2, y2), as the kernels
    do."""
    either = i1 | i2
    dx, dy = fld.sub(x2, x1), fld.sub(y2, y1)
    same_x = ~either & _is_zero(dx, fld)
    dbl = same_x & _is_zero(dy, fld)
    cancel = same_x & ~dbl
    one = fld.one_like(x1)
    den = fld.where(either | cancel, one,
                    fld.where(dbl, fld.add(y1, y1), dx))
    xx = fld.sqr(x1)
    num = fld.where(dbl, fld.add(fld.add(xx, xx), xx), dy)
    lam = fld.mul(num, F.batch_inv(fld, den))
    x3 = fld.sub(fld.sub(fld.sqr(lam), x1), x2)
    y3 = fld.sub(fld.mul(lam, fld.sub(x1, x3)), y1)
    x3 = fld.where(i1 | cancel, x2, fld.where(i2, x1, x3))
    y3 = fld.where(i1 | cancel, y2, fld.where(i2, y1, y3))
    return x3, y3, (i1 & i2) | cancel


def _is_zero(a, fld) -> torch.Tensor:
    """Per element of l16 values: all limbs zero."""
    return (a == 0).flatten(0, fld.nel - 1).all(0)


def tree_level_plain(x, y, inf, is_g2: bool):
    """One fold-half level: (*E, M, W, n) -> (*E, M, W, n/2)."""
    fld = ec.field_of(is_g2)
    h = x.shape[-1] // 2
    X, Y = F.unpack(x), F.unpack(y)
    x3, y3, i3 = affine_level(X[..., :h], Y[..., :h], inf[..., :h],
                              X[..., h:], Y[..., h:], inf[..., h:], fld)
    return F.pack(x3), F.pack(y3), i3


def tree_level0_plain(tabx, taby, d, is_g2: bool):
    """Level 0 on one chunk: selection, then the fold-half level."""
    return tree_level_plain(*select_tables(tabx, taby, d, is_g2), is_g2)


def proj_of_affine(x, y, inf, is_g2: bool):
    """Flagged affine -> complete projective: inf -> (0 : 1 : 0)."""
    zero, one, _ = ec.identity_like(x, is_g2)
    ne = ec.elem_axes(is_g2)
    m = inf.view((1,) * ne + tuple(inf.shape))
    return (torch.where(m, zero, x), torch.where(m, one, y),
            torch.where(m, zero, one))
