"""The four tree-level kernels of ``csrc/tree.cu``, the chunk carry of
``csrc/ec.cu`` and the chunk loop of the tree MSM.

Kernel wrappers (plain versions in ``engine.msm_tree`` and here):

  tree_level0(tabx, taby, d, is_g2)  <- pallas_tree.tree_level0_fused[_g2]
  tree_level(x, y, inf, is_g2)       <- pallas_tree.tree_level[_g2]
  chunk_carry(acc, x, y, inf, is_g2) <- the carry scan of
                                        msm_tree.tree_window_sums

The loop mirrors pallas_tree.tree_window_sums_fused /
msm_tree_fused (and their _g2 twins): digits once for all chunks; per
chunk level 0, then levels until ``TAIL`` (128) pair columns remain;
those affine partials add into the projective chunk carry (one launch);
then the lane fold and Horner (one launch each).  Keeping the
reference's schedule lets a level of the port be held against a level
of the reference.
"""

from __future__ import annotations

import torch

from . import ec, msm as MSM, msm_tree as MT
from ._build import kernel

TREE_LEVEL0 = {False: kernel("tree_level0_g1", "tree", "ppppppiii"),
               True: kernel("tree_level0_g2", "tree", "ppppppiii")}
TREE_LEVEL = {False: kernel("tree_level_g1", "tree", "ppppppiii"),
              True: kernel("tree_level_g2", "tree", "ppppppiii")}
CARRY = {False: kernel("ec_carry_g1", "ec", "ppppppii"),
         True: kernel("ec_carry_g2", "ec", "ppppppii")}

TAIL = 128  # partials per window left to the projective tail


def _elem_shape(is_g2: bool) -> tuple[int, ...]:
    return (8, 2) if is_g2 else (8,)


def tree_level0(tabx, taby, d, is_g2: bool):
    """Level 0 of one chunk with in-kernel digit selection.

    tabx, taby: (8, *E, M, S) int32; d: (W, M, S) int8 ->
    x, y (*E, M, W, S/2) int32, inf (M, W, S/2) bool."""
    if tabx.device.type == "cpu":
        return MT.tree_level0_plain(tabx, taby, d, is_g2)
    W, M, S = d.shape
    E = _elem_shape(is_g2)
    if (tabx.shape != (MT.HALF,) + E + (M, S) or taby.shape != tabx.shape
            or tabx.dtype != torch.int32 or taby.dtype != torch.int32
            or d.dtype != torch.int8 or S % 2):
        raise ValueError("tree_level0: bad table/digit shapes or types")
    x3 = torch.empty(E + (M, W, S // 2), dtype=torch.int32,
                     device=tabx.device)
    y3 = torch.empty_like(x3)
    inf3 = torch.empty((M, W, S // 2), dtype=torch.bool, device=tabx.device)
    TREE_LEVEL0[is_g2](tabx.contiguous(), taby.contiguous(), d.contiguous(),
                       x3, y3, inf3, M, W, S)
    return x3, y3, inf3


def tree_level(x, y, inf, is_g2: bool):
    """One fold-half level: (*E, M, W, n) -> (*E, M, W, n/2)."""
    if x.device.type == "cpu":
        return MT.tree_level_plain(x, y, inf, is_g2)
    M, W, n = inf.shape
    E = _elem_shape(is_g2)
    if (x.shape != E + (M, W, n) or y.shape != x.shape
            or x.dtype != torch.int32 or y.dtype != torch.int32
            or inf.dtype != torch.bool or n % 2):
        raise ValueError("tree_level: bad point/flag shapes or types")
    x3 = torch.empty(E + (M, W, n // 2), dtype=torch.int32, device=x.device)
    y3 = torch.empty_like(x3)
    inf3 = torch.empty((M, W, n // 2), dtype=torch.bool, device=x.device)
    TREE_LEVEL[is_g2](x.contiguous(), y.contiguous(), inf.contiguous(),
                      x3, y3, inf3, M, W, n)
    return x3, y3, inf3


def chunk_partials(tabx, taby, d, is_g2: bool):
    """One chunk's per-window partials: flagged affine x, y (*E, M, W,
    T), inf (M, W, T)."""
    if d.shape[-1] <= TAIL:
        return MT.select_tables(tabx, taby, d, is_g2)
    x, y, inf = tree_level0(tabx, taby, d, is_g2)
    while x.shape[-1] > TAIL:
        x, y, inf = tree_level(x, y, inf, is_g2)
    return x, y, inf


def chunk_carry_plain(acc, x, y, inf, is_g2: bool):
    p = MT.proj_of_affine(x, y, inf, is_g2)
    return p if acc is None else ec.ec_add_plain(acc, p, is_g2)


def chunk_carry(acc, x, y, inf, is_g2: bool):
    """acc + the chunk's flagged affine partials x, y (*E, M, W, T), inf
    (M, W, T), as projective (X, Y, Z); acc None: the partials alone.
    On CUDA one launch, acc updated in place."""
    if x.device.type == "cpu":
        return chunk_carry_plain(acc, x, y, inf, is_g2)
    x, y, inf = x.contiguous(), y.contiguous(), inf.contiguous()
    if (x.shape != _elem_shape(is_g2) + inf.shape or y.shape != x.shape
            or x.dtype != torch.int32 or y.dtype != torch.int32
            or inf.dtype != torch.bool
            or (acc is not None and any(
                c.shape != x.shape or c.dtype != torch.int32
                or not c.is_contiguous() for c in acc))):
        raise ValueError("chunk_carry: bad point/flag shapes or types")
    first = acc is None
    if first:
        acc = tuple(torch.empty_like(x) for _ in range(3))
    CARRY[is_g2](*acc, x, y, inf, inf.numel(), int(first))
    return acc


def window_digits(tables: MT.AffineTables, scalars):
    """scalars (16, M, n<=C*S) plain limbs -> (C, W, M, S) int8 digits,
    identity columns zeroed."""
    C, S, M = tables.chunks, tables.chunk_cols, tables.m
    n_pad = C * S
    if scalars.shape[-1] < n_pad:
        scalars = torch.nn.functional.pad(
            scalars, (0, n_pad - scalars.shape[-1]))
    d = MSM.signed_digits(scalars)                    # (W, M, C*S)
    d = d.reshape(MT.WIN, M, C, S).permute(2, 0, 1, 3).contiguous()
    return MT.mask_ident_digits(d, tables.ident)


def tree_window_sums(tables: MT.AffineTables, scalars):
    """Per-window sums of M MSMs: projective leaves (*E, M, W)."""
    is_g2 = tables.is_g2
    d = window_digits(tables, scalars)
    acc = None
    for c in range(tables.chunks):
        acc = chunk_carry(acc, *chunk_partials(tables.tx[c], tables.ty[c],
                                               d[c], is_g2), is_g2)
    return MSM.lane_fold(acc, is_g2)


def msm_tree(tables: MT.AffineTables, scalars):
    """M same-size MSMs over staged affine tables.

    scalars: (16, M, n) plain 16-bit limbs (int tensor, n <= C*S).
    Returns projective Montgomery leaves (*E, M)."""
    return MSM.horner_windows(tree_window_sums(tables, scalars), tables.is_g2,
                              4)
