"""G1 (over Fq) and G2 (over Fq2) group law on limb tensors.

Complete projective addition (Renes-Costello-Batina 2015, a = 0;
identity (0 : 1 : 0)), branchless, complete on the prime-order
subgroups Groth16 works in.  Points at kernel boundaries are tuples
(X, Y, Z) of canonical Montgomery l32 tensors: ``(8, ...)`` for G1,
``(8, 2, ...)`` for G2 (``engine.field``).

Two kernels of ``csrc/ec.cu`` back this module, each with its plain
version here: ``ec_add`` (the table build at staging) and
``to_affine`` (staged tables to affine); the others, ``ec_fold`` and
``horner``, are wrapped in ``engine.msm``, ``ec_carry`` in
``engine.cuda_tree``.  A wrapper runs the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curve import B2, Q, Fq2
from . import field as F
from ._build import kernel

_B3_G1 = 9          # 3 * b, b = 3
_B3_G2 = (3 * B2.c0 % Q, 3 * B2.c1 % Q)


def field_of(is_g2: bool):
    return F.FQ2 if is_g2 else F.FQ


def _b3(fld, like):
    if fld is F.FQ2:
        return fld.const(F.FQ.to_mont_int(_B3_G2[0]),
                         F.FQ.to_mont_int(_B3_G2[1]), like)
    return fld.const(F.FQ.to_mont_int(_B3_G1), like)


def point_add(p, q, fld):
    """(X1:Y1:Z1) + (X2:Y2:Z2) on l16 coordinates; complete.  Three
    batched multiplication layers, the same operation order as
    csrc/ec.cu (and the reference's ec.point_add), so both produce the
    same projective coordinates."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    sxy1, sxy2, syz1, syz2, sxz1, sxz2 = fld.add_many(
        [(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2)]
    )
    t0, t1, t2, m3, m4, m5 = fld.mul_many(
        [(X1, X2), (Y1, Y2), (Z1, Z2), (sxy1, sxy2), (syz1, syz2),
         (sxz1, sxz2)]
    )
    a01, a12, a02, x3d = fld.add_many(
        [(t0, t1), (t1, t2), (t0, t2), (t0, t0)]
    )
    t3, t4, y3 = fld.sub_many([(m3, a01), (m4, a12), (m5, a02)])
    t0 = fld.add(x3d, t0)                         # 3 * X1X2
    b3c = _b3(fld, t2)
    t2b, y3b = fld.mul_many([(t2, b3c), (y3, b3c)])
    Z3 = fld.add(t1, t2b)
    t1 = fld.sub(t1, t2b)
    p0, p1, p2, p3, p4, p5 = fld.mul_many(
        [(t4, y3b), (t3, t1), (y3b, t0), (t1, Z3), (t0, t3), (Z3, t4)]
    )
    X3 = fld.sub(p1, p0)
    Y3, Z3 = fld.add_many([(p3, p2), (p5, p4)])
    return X3, Y3, Z3


# -- kernels and their plain versions -------------------------------------------

EC_ADD = {False: kernel("ec_add_g1", "ec", "pppppppppi"),
          True: kernel("ec_add_g2", "ec", "pppppppppi")}
TO_AFFINE = {False: kernel("to_affine_g1", "ec", "pppppi"),
             True: kernel("to_affine_g2", "ec", "pppppi")}


def on_curve(X, Y, Z, is_g2: bool) -> torch.Tensor:
    """Whether each point of projective Montgomery l32 coordinates
    satisfies Y^2 Z = X^3 + b Z^3 (b = 3 in G1, 3/(9+i) on the G2
    twist), as a bool tensor over the points' axes on their device, with
    no host read; the identity (0 : 1 : 0) does.  Tensor code, three
    batched product layers: the staging check of raw pk queries (the
    reference's engine _assert_g1_on_curve / _assert_g2_on_curve run it
    in XLA)."""
    fld = field_of(is_g2)
    x, y, z = (F.unpack(c) for c in (X, Y, Z))
    x2, y2, z2 = fld.mul_many([(x, x), (y, y), (z, z)])
    x3, y2z, z3 = fld.mul_many([(x2, x), (y2, z), (z2, z)])
    b = (fld.const(F.FQ.to_mont_int(B2.c0), F.FQ.to_mont_int(B2.c1), z3)
         if is_g2 else fld.const(F.FQ.to_mont_int(3), z3))
    eq = y2z == fld.add(x3, fld.mul(z3, b))
    return eq.flatten(0, elem_axes(is_g2) - 1).all(0)


def ec_add_plain(p, q, is_g2: bool):
    fld = field_of(is_g2)
    out = point_add(tuple(F.unpack(c) for c in p),
                    tuple(F.unpack(c) for c in q), fld)
    return tuple(F.pack(c) for c in out)


def to_affine_plain(X, Y, Z, is_g2: bool):
    fld = field_of(is_g2)
    zi = F.batch_inv(fld, F.unpack(Z))
    return (F.pack(fld.mul(F.unpack(X), zi)),
            F.pack(fld.mul(F.unpack(Y), zi)))


def elem_axes(is_g2: bool) -> int:
    """Number of element axes: limbs (G1), limbs and component (G2)."""
    return 2 if is_g2 else 1


def _flat(c, is_g2):
    """(8[,2], ...) -> contiguous (8[,2], n)."""
    lead = elem_axes(is_g2)
    return c.reshape(tuple(c.shape[:lead]) + (-1,)).contiguous()


def ec_add(p, q, is_g2: bool):
    """Elementwise P + Q over equal-shaped coordinate tensors."""
    if p[0].device.type == "cpu":
        return ec_add_plain(p, q, is_g2)
    shape = p[0].shape
    ins = [_flat(c, is_g2) for c in (*p, *q)]
    for c in ins:
        if c.dtype != torch.int32 or c.shape != ins[0].shape:
            raise ValueError("ec_add: int32 coordinates of one shape")
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    EC_ADD[is_g2](*ins, *outs, ins[0].shape[-1])
    return tuple(o.view(shape) for o in outs)


def to_affine(X, Y, Z, is_g2: bool):
    """Projective -> affine (x, y) = (X/Z, Y/Z), with 1/0 taken as 0."""
    if X.device.type == "cpu":
        return to_affine_plain(X, Y, Z, is_g2)
    shape = X.shape
    ins = [_flat(c, is_g2) for c in (X, Y, Z)]
    for c in ins:
        if c.dtype != torch.int32 or c.shape != ins[0].shape:
            raise ValueError("to_affine: int32 coordinates of one shape")
    outs = [torch.empty_like(ins[0]) for _ in range(2)]
    TO_AFFINE[is_g2](*ins, *outs, ins[0].shape[-1])
    return tuple(o.view(shape) for o in outs)


def identity_like(coord, is_g2: bool):
    """(0 : 1 : 0) in l32, shaped like ``coord``."""
    fld = field_of(is_g2)
    one = F.pack(fld.one_like(F.unpack(coord[..., :1]))).expand_as(coord)
    zero = torch.zeros_like(coord)
    return zero, one.contiguous(), zero.clone()


# -- host conversions -----------------------------------------------------------


def g1_limb_coords(points) -> tuple[np.ndarray, ...]:
    """Host affine G1 points (None = infinity) -> projective (x, y, z)
    as (16, n) uint32 plain limbs, infinity as (0 : 1 : 0)."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return tuple(F.ints_to_limbs(v) for v in (xs, ys, zs))


def g2_limb_coords(points) -> tuple[np.ndarray, ...]:
    """-> (x0, x1, y0, y1, z0, z1) (16, n) uint32 plain limbs."""
    x0 = [0 if p is None else p[0].c0 for p in points]
    x1 = [0 if p is None else p[0].c1 for p in points]
    y0 = [1 if p is None else p[1].c0 for p in points]
    y1 = [0 if p is None else p[1].c1 for p in points]
    z0 = [0 if p is None else 1 for p in points]
    z1 = [0] * len(points)
    return tuple(F.ints_to_limbs(v) for v in (x0, x1, y0, y1, z0, z1))


def points_to_device(points, is_g2: bool, device="cpu"):
    """Host affine points -> projective Montgomery l32 (X, Y, Z):
    (8, n) for G1, (8, 2, n) for G2."""
    def mont(a):
        t = torch.from_numpy(a.astype(np.int64)).to(device)
        return F.pack(F.FQ.to_mont(t))

    if not is_g2:
        return tuple(mont(a) for a in g1_limb_coords(points))
    c = g2_limb_coords(points)
    return tuple(mont(np.stack([c[i], c[i + 1]], axis=1)) for i in (0, 2, 4))


def _fq_ints(c) -> list[int]:
    """(8, n) l32 Montgomery tensor -> plain ints."""
    return [F.FQ.from_mont_int(v) for v in F.l32_to_ints(c.cpu().numpy())]


def g1_points_from_device(X, Y, Z) -> list:
    """(8, M) projective Montgomery -> M host affine points (or None)."""
    out = []
    for x, y, z in zip(_fq_ints(X), _fq_ints(Y), _fq_ints(Z)):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, Q)
        out.append((x * zi % Q, y * zi % Q))
    return out


def g2_points_from_device(X, Y, Z) -> list:
    """(8, 2, M) projective Montgomery -> M host affine G2 points."""
    def fq2s(c):
        return [Fq2(a, b) for a, b in zip(_fq_ints(c[:, 0]),
                                          _fq_ints(c[:, 1]))]

    out = []
    for x, y, z in zip(fq2s(X), fq2s(Y), fq2s(Z)):
        if z.is_zero():
            out.append(None)
            continue
        zi = z.inv()
        out.append((x * zi, y * zi))
    return out
