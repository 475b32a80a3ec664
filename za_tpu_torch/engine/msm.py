"""Scalar digits at radix 16 (signed) or 4, and the projective tail of
the MSM.

* ``signed_digits``: (16, ...) plain 16-bit scalar limbs (< 2^254) ->
  (64, ...) int8 digits d_w in [-8, 8] with s = sum d_w 16^w, by the
  reference's carry-free closed form (za_tpu/engine/msm.py
  signed_digits): d_w = raw_w + top(raw_{w-1}) - 16 top(raw_w), where
  top(v) = v >> 3.
* ``radix4_digits``: the same limbs -> (127, ...) int8 unsigned 2-bit
  windows, s = sum d_w 4^w (za_tpu/engine/msm.py msm_limbs_dense).
* ``lane_fold``: sums the last axis of a projective point tensor.
* ``horner_windows``: combines per-window sums MSB first, ``bits``
  doublings per window (kernel ``horner`` of csrc/ec.cu).
The lane fold runs on the ``ec_add`` kernel (``engine.ec``).
"""

from __future__ import annotations

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


def lane_fold(p, is_g2: bool):
    """Sum over the last axis (a power of two) by fold-half adds:
    leaves (.., L) -> (..)."""
    while p[0].shape[-1] > 1:
        h = p[0].shape[-1] // 2
        p = ec.ec_add(tuple(c[..., :h] for c in p),
                      tuple(c[..., h:] for c in p), is_g2)
    return tuple(c[..., 0] for c in p)


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
