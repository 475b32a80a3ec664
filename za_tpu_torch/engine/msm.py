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


FOLD = {False: kernel("ec_fold_g1", "ec", "ppppppiiiii"),
        True: kernel("ec_fold_g2", "ec", "ppppppiiiii")}
FOLD_MAX_LANES = 512   # csrc/ec.cu FOLD_MAX_LANES (a group in shared memory)
FOLD_MAX_SPLIT = 8     # csrc/ec.cu FOLD_MAX_SPLIT (blocks of a cluster)
# warps of a fold block, and the widest level (in adds) that still runs
# staged adds over lanes, a wider one running one add per thread; with
# fold_split's rule, chosen by tools/torch_fold_sweep.py at the proofs'
# shapes (PERF.md): every G1 level staged, G2 levels of more than 64
# adds (L >= 256) one add a thread.
FOLD_WARPS = {False: 8, True: 16}
FOLD_STAGED_MAX = {False: 1 << 30, True: 64}
_SMS: dict = {}


def sm_count(device) -> int:
    """The card's SMs, read once per device."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def fold_split(G: int, L: int, device) -> int:
    """Blocks per group: the most (a power of two, at most
    FOLD_MAX_SPLIT and L) that keep the G groups' blocks to one per SM
    of the card; past that the split lost at every shape measured (a G2
    block, 512 threads at 128 registers, fills an SM's register file)."""
    sms = sm_count(device)
    k = 1
    while 2 * k <= min(FOLD_MAX_SPLIT, L) and G * 2 * k <= sms:
        k *= 2
    return k


def lane_fold_plain(p, is_g2: bool):
    while p[0].shape[-1] > 1:
        h = p[0].shape[-1] // 2
        p = ec.ec_add_plain(tuple(c[..., :h] for c in p),
                            tuple(c[..., h:] for c in p), is_g2)
    return tuple(c[..., 0] for c in p)


def lane_fold(p, is_g2: bool):
    """Sum over the last axis L (a power of two, at most FOLD_MAX_LANES)
    by fold-half levels, lane i + L/2 into lane i, then the same on the
    first half: leaves (*E, .., L) -> (*E, ..).  One launch."""
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
    FOLD[is_g2](*p, *outs, G, L, FOLD_STAGED_MAX[is_g2], FOLD_WARPS[is_g2],
                fold_split(G, L, p[0].device))
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
