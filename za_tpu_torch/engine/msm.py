"""Scalar digits at radix 16 (signed) or 4, and the projective tail of
the MSM.

* ``signed_digits``: (16, ...) plain 16-bit scalar limbs (< 2^254) ->
  (64, ...) int8 digits d_w in [-8, 8] with s = sum d_w 16^w, by the
  reference's carry-free closed form (za_tpu/engine/msm.py
  signed_digits): d_w = raw_w + top(raw_{w-1}) - 16 top(raw_w), where
  top(v) = v >> 3.
* ``radix4_digits``: the same limbs -> (127, ...) int8 unsigned 2-bit
  windows, s = sum d_w 4^w (za_tpu/engine/msm.py msm_limbs_dense).
* ``lane_fold``: sums the last axis of a projective point tensor by
  fold-half levels (kernel ``ec_fold`` of csrc/ec.cu, one launch).
* ``horner_windows``: combines per-window sums MSB first, ``bits``
  doublings per window (kernel ``horner`` of csrc/ec.cu).
"""

from __future__ import annotations

import functools
import math

import torch

from . import ec
from ._build import kernel

# window width in bits -> number of windows of a scalar below 2^254
WINDOWS = {4: 64,    # signed radix 16: 64 * 4 = 256 bits, room for the carry
           2: 127}   # unsigned radix 4: 127 * 2 = 254 bits


def signed_digits(scalars: torch.Tensor) -> torch.Tensor:
    """(16, ...) int plain limbs -> (64, ...) int8 signed digits."""
    s = scalars.to(torch.int32)
    shifts = torch.arange(0, 16, 4, dtype=torch.int32, device=s.device)
    shifts = shifts.view((1, 4) + (1,) * (s.dim() - 1))
    raw = ((s.unsqueeze(1) >> shifts) & 15).reshape(
        (WINDOWS[4],) + tuple(s.shape[1:]))
    top = raw >> 3
    prev = torch.cat([torch.zeros_like(top[:1]), top[:-1]])
    return (raw + prev - (top << 4)).to(torch.int8)


def radix4_digits(scalars: torch.Tensor) -> torch.Tensor:
    """(16, ...) int plain limbs -> (127, ...) int8 digits in [0, 3];
    window w holds bits [2w, 2w + 2)."""
    s = scalars.to(torch.int32)
    shifts = torch.arange(0, 16, 2, dtype=torch.int32, device=s.device)
    shifts = shifts.view((1, 8) + (1,) * (s.dim() - 1))
    raw = ((s.unsqueeze(1) >> shifts) & 3).reshape((128,) + tuple(s.shape[1:]))
    return raw[:WINDOWS[2]].to(torch.int8)


FOLD = {False: kernel("ec_fold_g1", "ec", "ppppppiiiiii"),
        True: kernel("ec_fold_g2", "ec", "ppppppiiiiii")}
FOLD_MAX_LANES = 512   # csrc/ec.cu FOLD_MAX_LANES (a window in shared memory)
FOLD_MAX_SPLIT = 8     # csrc/ec.cu FOLD_MAX_SPLIT (blocks of a cluster)
FOLD_MAX_WARPS = 16    # csrc/ec.cu FOLD_MAX_THREADS / 32
SMEM = 232448          # shared memory a block may take, bytes
POINT_BYTES = {False: 96, True: 192}   # a projective point in shared memory
# a warp's staged adds at once (G1 on 6-lane units, G2 on 16-lane:
# csrc/ec.cu FOLD_G2_WIDTH) and their scratch (hw1::SLOTS, hw2::SLOTS
# Fq each), bytes; a warp's thread adds at once
STAGED_UNITS = {False: 5, True: 2}
STAGED_SCRATCH = {False: 5 * 25 * 32, True: 2 * 90 * 32}
THREAD_ADDS = 32
# The widest level (adds a block) that still runs staged, a wider one
# one add a thread (G1; G2's thread add is not compiled in): chosen with
# fold_plan's rule by tools/torch_fold_sweep.py at the proofs' shapes
# (PERF.md): G1's levels of 128 adds and more (2^13) one add a thread,
# its 96 (2^17 g1abl, B = 3) staged.
FOLD_STAGED_MAX = {False: 96, True: 1 << 30}
_SMS: dict = {}


def sm_count(device) -> int:
    """The card's SMs, read once per device."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def fold_plan(G: int, L: int, is_g2: bool, device) -> tuple[int, int, int,
                                                             int]:
    """The fold's plan on this card (_fold_plan, cached: a proof asks for
    the same few shapes, and the search costs the host ~10 us)."""
    return _fold_plan(G, L, is_g2, sm_count(device), FOLD_STAGED_MAX[is_g2])


@functools.lru_cache(maxsize=None)
def _fold_plan(G: int, L: int, is_g2: bool, sms: int,
               wide: int) -> tuple[int, int, int, int]:
    """(B windows a block, K blocks a window, warps, widest staged
    level) of the fold of G windows of L lanes on a card of sms SMs,
    levels of more than `wide` adds one a thread: the G windows spread as
    evenly as the card's SMs allow in one wave of blocks (a block an
    SM), the fewest windows an SM (B / K; K a power of two up to
    FOLD_MAX_SPLIT and L, B a divisor of G whose lanes fit shared
    memory), ties to the smaller K; where no plan fits one wave, the
    fewest windows an SM over the waves; warps for the block's widest
    thread and staged levels (THREAD_ADDS and STAGED_UNITS adds a warp),
    a power of two from 4 to FOLD_MAX_WARPS, as many as fit."""
    pb, best = POINT_BYTES[is_g2], None
    K = 1
    while K <= min(FOLD_MAX_SPLIT, L):
        for B in range(1, G + 1):
            if G % B:
                continue
            lanes = max(L // K, K) * B
            if lanes * pb + STAGED_SCRATCH[is_g2] > SMEM:
                break
            waves = -(-(G // B * K) // sms)
            key = (waves > 1, waves * B / K, K)
            if best is None or key < best[0]:
                best = (key, B, K)
            if waves == 1:      # a larger B only adds windows an SM
                break
        K *= 2
    _, B, K = best
    lanes = max(L // K, K) * B
    top = staged = lanes // 2                # adds of the widest level
    while staged > wide:                     # and of the widest staged one
        staged //= 2
    need = max(-(-staged // STAGED_UNITS[is_g2]),
               -(-top // THREAD_ADDS) if top > wide else 1)
    warps = min(FOLD_MAX_WARPS, max(4, 1 << (need - 1).bit_length()))
    while warps > 1 and lanes * pb + warps * STAGED_SCRATCH[is_g2] > SMEM:
        warps //= 2
    return B, K, warps, wide


def lane_fold_plain(p, is_g2: bool):
    while p[0].shape[-1] > 1:
        h = p[0].shape[-1] // 2
        p = ec.ec_add_plain(tuple(c[..., :h] for c in p),
                            tuple(c[..., h:] for c in p), is_g2)
    return tuple(c[..., 0] for c in p)


def lane_fold(p, is_g2: bool):
    """Sum over the last axis L (a power of two, at most FOLD_MAX_LANES)
    by fold-half levels, lane i + L/2 into lane i, then the same on the
    first half: leaves (*E, .., L) -> (*E, ..).  One launch, planned by
    fold_plan."""
    if p[0].device.type == "cpu":
        return lane_fold_plain(p, is_g2)
    p = tuple(c.contiguous() for c in p)
    shape, ne = p[0].shape, ec.elem_axes(is_g2)
    L = shape[-1]
    if (shape[:ne] != ((8, 2) if is_g2 else (8,)) or len(shape) < ne + 1
            or L < 1 or L > FOLD_MAX_LANES or L & (L - 1)
            or any(c.shape != shape or c.dtype != torch.int32 for c in p)):
        raise ValueError(f"lane_fold: int32 points (*E, .., L) of one shape,"
                         f" L a power of two up to {FOLD_MAX_LANES}")
    outs = [torch.empty(shape[:-1], dtype=torch.int32, device=p[0].device)
            for _ in range(3)]
    G = math.prod(shape[ne:-1])
    if G == 0:
        return tuple(outs)
    B, K, warps, wide = fold_plan(G, L, is_g2, p[0].device)
    FOLD[is_g2](*p, *outs, G, L, B, K, wide, warps)
    return tuple(outs)


HORNER = {False: kernel("horner_g1", "ec", "ppppppiii"),
          True: kernel("horner_g2", "ec", "ppppppiii")}


def horner_windows_plain(wsum, is_g2: bool, bits: int):
    acc = ec.identity_like(wsum[0][..., 0], is_g2)
    for w in range(wsum[0].shape[-1] - 1, -1, -1):
        for _ in range(bits):
            acc = ec.ec_add_plain(acc, acc, is_g2)
        acc = ec.ec_add_plain(acc, tuple(c[..., w] for c in wsum), is_g2)
    return acc


def horner_windows(wsum, is_g2: bool, bits: int):
    """Per-window sums, leaves (*E, M, W) with W = WINDOWS[bits] ->
    sum_w 2^(bits w) S_w, leaves (*E, M): one launch, one warp per
    MSM."""
    if wsum[0].device.type == "cpu":
        return horner_windows_plain(wsum, is_g2, bits)
    wsum = tuple(c.contiguous() for c in wsum)
    E, (M, W) = wsum[0].shape[:-2], wsum[0].shape[-2:]
    if (W != WINDOWS.get(bits) or any(c.shape != wsum[0].shape
                                      or c.dtype != torch.int32
                                      for c in wsum)):
        raise ValueError(f"horner_windows: int32 (*E, M, {WINDOWS.get(bits)})"
                         f" window sums for {bits}-bit windows")
    outs = [torch.empty(E + (M,), dtype=torch.int32, device=wsum[0].device)
            for _ in range(3)]
    HORNER[is_g2](*wsum, *outs, M, W, bits)
    return tuple(outs)
