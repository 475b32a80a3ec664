"""Dense MSM: per-lane window sums over stacked projective multiples,
then the lane fold and Horner of ``engine.msm``.

One function at two radices, as in the reference:

* signed radix 16 (the default): {1P..8P}, 64 digits in [-8, 8];
  za_tpu/engine/pallas_msm_rns.py dense_window_sums_pallas /
  msm_signed_dense_pallas and msm.py signed_window_sums /
  msm_signed_dense;
* unsigned radix 4 (``msm_style="fused"``): {P, 2P, 3P}, 127 digits in
  [0, 3]; za_tpu/engine/pallas_msm.py dense_msm_window_sums and msm.py
  msm_limbs_dense_fused.

For MSM m, window w and lane l the window sum is
S[m, w, l] = sum_{i = l mod L} d_{w,i} P_i (d < 0 negates Y, d = 0 adds
nothing), accumulated in order of i by complete projective additions.
Kernel wrappers: ``dense_window_sums`` (``csrc/dense.cu``; its plain
version ``dense_window_sums_plain`` here).  The multiples are built once
per staged query by ``build_tables`` (``ec_add``).

Layouts (l32; E = (8,) for G1, (8, 2) for G2):
  tables x, y, z: (K, *E, M, n) int32, K = 8 (radix 16) or 3 (radix 4)
  digits: (W, M, n) int8
  per-lane sums: (*E, M, W, L) int32
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import ec, field as F, msm as MSM
from ._build import kernel

MULTIPLES = {16: 8, 4: 3}   # radix -> table entries {1P..KP}
BITS = {16: 4, 4: 2}        # radix -> window width
THREADS = 1 << 15           # accumulators per launch that fill the card


@dataclass
class DenseTables:
    """Staged dense-MSM operand: the multiples {1P..KP} of M queries of
    n points each (identity-padded), canonical Montgomery."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    is_g2: bool

    @property
    def radix(self) -> int:
        return 16 if self.x.shape[0] == MULTIPLES[16] else 4

    @property
    def m(self) -> int:
        return self.x.shape[-2]

    @property
    def n(self) -> int:
        return self.x.shape[-1]


def build_tables(points, is_g2: bool, radix: int) -> DenseTables:
    """Projective points (X, Y, Z), each (*E, M, n) int32 -> their
    multiples {1P..KP}: K - 1 ec_add launches."""
    pts = [tuple(points)]
    for _ in range(MULTIPLES[radix] - 1):
        pts.append(ec.ec_add(pts[-1], pts[0], is_g2))
    return DenseTables(*(torch.stack([p[i] for p in pts]) for i in range(3)),
                       is_g2=is_g2)


def digits(scalars: torch.Tensor, radix: int) -> torch.Tensor:
    """(16, M, n) plain scalar limbs -> (W, M, n) int8 digits."""
    if radix == 16:
        return MSM.signed_digits(scalars)
    return MSM.radix4_digits(scalars)


def lanes(M: int, n: int, radix: int) -> int:
    """Lanes per window: the largest power of two L <= n with
    M * W * L <= THREADS (at least 1)."""
    W = MSM.WINDOWS[BITS[radix]]
    L = 1
    while 2 * L <= n and 2 * L * M * W <= THREADS:
        L *= 2
    return L


# -- the kernel and its plain version ------------------------------------------

DENSE = {(16, False): kernel("dense_window_sums_g1", "dense", "pppppppiii"),
         (16, True): kernel("dense_window_sums_g2", "dense", "pppppppiii"),
         (4, False): kernel("dense4_window_sums_g1", "dense", "pppppppiii"),
         (4, True): kernel("dense4_window_sums_g2", "dense", "pppppppiii")}


def dense_window_sums_plain(tabs: DenseTables, d: torch.Tensor, L: int):
    """The kernel's loop over chunks of L points, on l16 tensors."""
    is_g2 = tabs.is_g2
    fld = ec.field_of(is_g2)
    ne = ec.elem_axes(is_g2)
    W, M, n = d.shape
    C = -(-n // L)
    pad = C * L - n
    d = torch.nn.functional.pad(d.to(torch.int64), (0, pad))
    # (K, *E, M, C*L) -> (*E, M, K, C*L): the multiple next to the columns
    tab = [torch.nn.functional.pad(t, (0, pad)).movedim(0, ne + 1)
           for t in (tabs.x, tabs.y, tabs.z)]
    acc = ec.identity_like(
        torch.empty(tab[0].shape[:ne] + (M, W, L), dtype=torch.int32,
                    device=d.device), is_g2)
    for c in range(C):
        dc = d[:, :, c * L:(c + 1) * L].permute(1, 0, 2)   # (M, W, L)
        k = (dc.abs().clamp(min=1) - 1).expand(tab[0].shape[:ne] + dc.shape)
        sel = [torch.gather(t[..., c * L:(c + 1) * L], ne + 1, k)
               for t in tab]
        y = F.unpack(sel[1])
        sel[1] = F.pack(fld.where(dc < 0, fld.neg(y), y))
        new = ec.ec_add_plain(acc, sel, is_g2)
        keep = (dc == 0).view((1,) * ne + tuple(dc.shape))
        acc = tuple(torch.where(keep, a, b) for a, b in zip(acc, new))
    return acc


def dense_window_sums(tabs: DenseTables, d: torch.Tensor, L: int):
    """Per-lane window sums: tables (K, *E, M, n), digits (W, M, n) int8
    -> projective (*E, M, W, L)."""
    if tabs.x.device.type == "cpu":
        return dense_window_sums_plain(tabs, d, L)
    is_g2, radix = tabs.is_g2, tabs.radix
    K, M, n = tabs.x.shape[0], tabs.m, tabs.n
    E = (8, 2) if is_g2 else (8,)
    W = MSM.WINDOWS[BITS[radix]]
    if (any(t.shape != (K,) + E + (M, n) or t.dtype != torch.int32
            for t in (tabs.x, tabs.y, tabs.z))
            or d.shape != (W, M, n) or d.dtype != torch.int8
            or L < 1 or L > n):
        raise ValueError("dense_window_sums: bad table/digit shapes or types")
    outs = [torch.empty(E + (M, W, L), dtype=torch.int32, device=d.device)
            for _ in range(3)]
    DENSE[(radix, is_g2)](tabs.x.contiguous(), tabs.y.contiguous(),
                          tabs.z.contiguous(), d.contiguous(), *outs, M, n, L)
    return tuple(outs)


def msm_dense(tabs: DenseTables, scalars: torch.Tensor):
    """M same-size MSMs over staged multiples.

    scalars: (16, M, n) plain 16-bit limbs (int tensor).  Returns
    projective Montgomery leaves (*E, M)."""
    radix = tabs.radix
    L = lanes(tabs.m, tabs.n, radix)
    acc = dense_window_sums(tabs, digits(scalars, radix), L)
    return MSM.horner_windows(MSM.lane_fold(acc, tabs.is_g2), tabs.is_g2,
                              BITS[radix])
