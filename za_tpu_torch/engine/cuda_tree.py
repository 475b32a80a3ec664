"""The four tree-level kernels of ``csrc/tree.cu`` and the chunk loop
of the tree MSM.

Kernel wrappers (plain versions in ``engine.msm_tree``):

  tree_level0(tabx, taby, d, is_g2)  <- pallas_tree.tree_level0_fused[_g2]
  tree_level(x, y, inf, is_g2)       <- pallas_tree.tree_level[_g2]

The loop mirrors pallas_tree.tree_window_sums_fused /
msm_tree_fused (and their _g2 twins): digits once for all chunks; per
chunk level 0, then levels until ``TAIL`` (128) pair columns remain;
those partials go projective and add into the chunk carry; then the
lane fold and Horner.  Keeping the reference's schedule lets a level
of the port be held against a level of the reference.
"""

from __future__ import annotations

import torch

from . import ec, msm as MSM, msm_tree as MT
from ._build import kernel

TREE_LEVEL0 = {False: kernel("tree_level0_g1", "tree", "ppppppiii"),
               True: kernel("tree_level0_g2", "tree", "ppppppiii")}
TREE_LEVEL = {False: kernel("tree_level_g1", "tree", "ppppppiii"),
              True: kernel("tree_level_g2", "tree", "ppppppiii")}

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
    """One chunk's per-window partials: projective (*E, M, W, T)."""
    S = d.shape[-1]
    if S > TAIL:
        x, y, inf = tree_level0(tabx, taby, d, is_g2)
        while x.shape[-1] > TAIL:
            x, y, inf = tree_level(x, y, inf, is_g2)
    else:
        x, y, inf = MT.select_tables(tabx, taby, d, is_g2)
    return MT.proj_of_affine(x, y, inf, is_g2)


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
        part = chunk_partials(tables.tx[c], tables.ty[c], d[c], is_g2)
        acc = part if acc is None else ec.ec_add(acc, part, is_g2)
    return MSM.lane_fold(acc, is_g2)


def msm_tree(tables: MT.AffineTables, scalars):
    """M same-size MSMs over staged affine tables.

    scalars: (16, M, n) plain 16-bit limbs (int tensor, n <= C*S).
    Returns projective Montgomery leaves (*E, M)."""
    return MSM.horner_windows(tree_window_sums(tables, scalars), tables.is_g2,
                              4)
