"""The four tree-level kernels of ``csrc/tree.cu``, the chunk carry of
``csrc/ec.cu`` and the chunk loop of the tree MSM.

Kernel wrappers (plain versions in ``engine.msm_tree`` and here):

  tree_level0(tabx, taby, d, is_g2)  <- pallas_tree.tree_level0_fused[_g2]
  tree_level(x, y, inf, is_g2)       <- pallas_tree.tree_level[_g2]
  chunk_carry(x, y, inf, is_g2)      <- the carry scan of
                                        msm_tree.tree_window_sums

The loop mirrors pallas_tree.tree_window_sums_fused /
msm_tree_fused (and their _g2 twins): digits once for all chunks; per
chunk level 0, then levels until ``TAIL`` (128) pair columns remain,
the last level writing into the chunk's slice of one buffer of every
chunk's flagged affine partials; then the chunk carry over that buffer,
the lane fold and Horner (one launch each).  Keeping the reference's
levels lets a level of the port be held against a level of the
reference.  The carry sums the chunks fold-half (chunk c + h into c),
where the reference scans them in order: the same points mod p.
"""

from __future__ import annotations

import torch

from . import ec, msm as MSM, msm_tree as MT
from ._build import kernel

TREE_LEVEL0 = {False: kernel("tree_level0_g1", "tree", "ppppppiii"),
               True: kernel("tree_level0_g2", "tree", "ppppppiii")}
TREE_LEVEL = {False: kernel("tree_level_g1", "tree", "ppppppiii"),
              True: kernel("tree_level_g2", "tree", "ppppppiii")}
CARRY = {False: kernel("ec_carry_g1", "ec", "ppppppiiiii"),
         True: kernel("ec_carry_g2", "ec", "ppppppiiiii")}

TAIL = 128  # partials per window left to the projective tail
# The carry's plan (carry_plan), chosen by tools/torch_fold_sweep.py at
# the proofs' shapes and at C = 64 / 128 (PERF.md): G1 levels one add a
# thread, G2 levels on staged adds of 8 lanes (csrc/ec.cu
# CARRY_G2_WIDTH, 4 a warp); the widest level (in adds) that still runs
# staged, a wider one one add a thread; at most CARRY_COLS columns a
# block.
CARRY_STAGED_MAX = {False: 0, True: 1 << 30}
CARRY_COLS = {False: 128, True: 32}
CARRY_PER_WARP = {False: 32, True: 4}   # adds a warp runs at once
CARRY_SCRATCH = {False: 0, True: 4 * 90 * 32}  # a warp's staged scratch, B


def _elem_shape(is_g2: bool) -> tuple[int, ...]:
    return (8, 2) if is_g2 else (8,)


def _into(res, out):
    """A plain version's (x, y, inf) written into out (if given)."""
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return out


def _outputs(shape, flags, device, out):
    """out, checked to be (x, y, inf) of these shapes, or new tensors."""
    if out is None:
        x = torch.empty(shape, dtype=torch.int32, device=device)
        return x, torch.empty_like(x), torch.empty(flags, dtype=torch.bool,
                                                   device=device)
    if (tuple(out[0].shape) != shape or tuple(out[1].shape) != shape
            or tuple(out[2].shape) != flags
            or any(o.device != device or not o.is_contiguous()
                   for o in out) or out[0].dtype != torch.int32
            or out[1].dtype != torch.int32 or out[2].dtype != torch.bool):
        raise ValueError("tree level: out must be contiguous int32 x, y "
                         f"{shape} and bool inf {flags} on {device}")
    return out


def tree_level0(tabx, taby, d, is_g2: bool, out=None):
    """Level 0 of one chunk with in-kernel digit selection.

    tabx, taby: (8, *E, M, S) int32; d: (W, M, S) int8 ->
    x, y (*E, M, W, S/2) int32, inf (M, W, S/2) bool, into out if given."""
    if tabx.device.type == "cpu":
        return _into(MT.tree_level0_plain(tabx, taby, d, is_g2), out)
    W, M, S = d.shape
    E = _elem_shape(is_g2)
    if (tabx.shape != (MT.HALF,) + E + (M, S) or taby.shape != tabx.shape
            or tabx.dtype != torch.int32 or taby.dtype != torch.int32
            or d.dtype != torch.int8 or S % 2):
        raise ValueError("tree_level0: bad table/digit shapes or types")
    x3, y3, inf3 = _outputs(E + (M, W, S // 2), (M, W, S // 2), tabx.device,
                            out)
    TREE_LEVEL0[is_g2](tabx.contiguous(), taby.contiguous(), d.contiguous(),
                       x3, y3, inf3, M, W, S)
    return x3, y3, inf3


def tree_level(x, y, inf, is_g2: bool, out=None):
    """One fold-half level: (*E, M, W, n) -> (*E, M, W, n/2), into out
    if given."""
    if x.device.type == "cpu":
        return _into(MT.tree_level_plain(x, y, inf, is_g2), out)
    M, W, n = inf.shape
    E = _elem_shape(is_g2)
    if (x.shape != E + (M, W, n) or y.shape != x.shape
            or x.dtype != torch.int32 or y.dtype != torch.int32
            or inf.dtype != torch.bool or n % 2):
        raise ValueError("tree_level: bad point/flag shapes or types")
    x3, y3, inf3 = _outputs(E + (M, W, n // 2), (M, W, n // 2), x.device,
                            out)
    TREE_LEVEL[is_g2](x.contiguous(), y.contiguous(), inf.contiguous(),
                      x3, y3, inf3, M, W, n)
    return x3, y3, inf3


def chunk_partials(tabx, taby, d, is_g2: bool, out=None):
    """One chunk's per-window partials: flagged affine x, y (*E, M, W,
    T), inf (M, W, T), T = min(S, TAIL); the last level writes into out
    if given."""
    if d.shape[-1] <= TAIL:
        return _into(MT.select_tables(tabx, taby, d, is_g2), out)
    x, y, inf = tree_level0(tabx, taby, d, is_g2,
                            out if d.shape[-1] // 2 <= TAIL else None)
    while x.shape[-1] > TAIL:
        x, y, inf = tree_level(x, y, inf, is_g2,
                               out if x.shape[-1] // 2 <= TAIL else None)
    return x, y, inf


def partials_buffer(tables: MT.AffineTables, device):
    """Every chunk's partials, uninitialised: x, y (C, *E, M, W, T)
    int32, inf (C, M, W, T) bool."""
    C, M = tables.chunks, tables.m
    T = min(tables.chunk_cols, TAIL)
    x = torch.empty((C,) + _elem_shape(tables.is_g2) + (M, MT.WIN, T),
                    dtype=torch.int32, device=device)
    return x, torch.empty_like(x), torch.empty(
        (C, M, MT.WIN, T), dtype=torch.bool, device=device)


def chunk_carry_plain(x, y, inf, is_g2: bool):
    """The carry's fold-half over the chunk axis, C padded to a power of
    two P in the schedule only: level h = P/2, .., 1 adds chunk c + h
    into chunk c for c < h where c + h < C (only the first level misses
    partners), each partial (x : y : 1), or (0 : 1 : 0) where inf."""
    ne = ec.elem_axes(is_g2)
    p = MT.proj_of_affine(x.movedim(0, ne), y.movedim(0, ne), inf, is_g2)
    n = inf.shape[0]
    h = 1
    while h < n:
        h *= 2
    h //= 2
    while h >= 1:
        k = n - h    # the chunks c < h with a partner c + h
        s = ec.ec_add_plain(tuple(c.narrow(ne, 0, k) for c in p),
                            tuple(c.narrow(ne, h, k) for c in p), is_g2)
        p = tuple(torch.cat([a, c.narrow(ne, k, h - k)], ne)
                  for a, c in zip(s, p))
        n, h = h, h // 2
    return tuple(c.select(ne, 0) for c in p)


def carry_plan(C: int, N: int, is_g2: bool, device) -> tuple[int, int]:
    """(columns, warps) of a carry block: the most columns (a power of
    two up to CARRY_COLS dividing N) that leave a block for every SM of
    the card and fit shared memory with four warps; warps for the
    widest level's adds (CARRY_PER_WARP a warp), 4 to 16, as many as
    fit."""
    P = 1 << (C - 1).bit_length()
    widest = max(C - P // 2, P // 4, 1)     # adds a column in one level
    pts, scratch = C * MSM.POINT_BYTES[is_g2], CARRY_SCRATCH[is_g2]
    B = CARRY_COLS[is_g2]
    while B > 1 and (N % B or N // B < MSM.sm_count(device)
                     or B * pts + 4 * scratch > MSM.SMEM):
        B //= 2
    warps = min(16, max(4, -(-B * widest // CARRY_PER_WARP[is_g2])))
    while warps > 1 and B * pts + warps * scratch > MSM.SMEM:
        warps //= 2
    return B, warps


def chunk_carry(x, y, inf, is_g2: bool):
    """The chunks' flagged affine partials x, y (C, *E, M, W, T), inf (C,
    M, W, T) summed over C: projective (X, Y, Z) (*E, M, W, T), the
    fold-half of chunk_carry_plain.  On CUDA one launch."""
    if x.device.type == "cpu":
        return chunk_carry_plain(x, y, inf, is_g2)
    E = _elem_shape(is_g2)
    if (inf.dim() != 4 or inf.shape[0] < 1 or x.shape != inf.shape[:1] + E
            + inf.shape[1:] or y.shape != x.shape or x.dtype != torch.int32
            or y.dtype != torch.int32 or inf.dtype != torch.bool):
        raise ValueError("chunk_carry: int32 x, y (C, *E, M, W, T) and "
                         "bool inf (C, M, W, T)")
    C, N = inf.shape[0], inf[0].numel()
    out = [torch.empty(E + inf.shape[1:], dtype=torch.int32, device=x.device)
           for _ in range(3)]
    B, warps = carry_plan(C, N, is_g2, x.device)
    CARRY[is_g2](x.contiguous(), y.contiguous(), inf.contiguous(), *out, C,
                 N, B, CARRY_STAGED_MAX[is_g2], warps)
    return tuple(out)


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
    x, y, inf = partials_buffer(tables, d.device)
    for c in range(tables.chunks):
        chunk_partials(tables.tx[c], tables.ty[c], d[c], is_g2,
                       (x[c], y[c], inf[c]))
    return MSM.lane_fold(chunk_carry(x, y, inf, is_g2), is_g2)


def msm_tree(tables: MT.AffineTables, scalars):
    """M same-size MSMs over staged affine tables.

    scalars: (16, M, n) plain 16-bit limbs (int tensor, n <= C*S).
    Returns projective Montgomery leaves (*E, M)."""
    return MSM.horner_windows(tree_window_sums(tables, scalars), tables.is_g2,
                              4)
