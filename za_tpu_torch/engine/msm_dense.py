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

For MSM m, window w and lane l of L, with S segments a lane, the window
sum is the per-lane sum at S L lanes, T[m, w, j] = sum_{i = j mod S L}
d_{w,i} P_i (d < 0 negates Y, d = 0 adds nothing, in order of i by
complete projective additions), folded fold-half from S L lanes down to
L (the first log2 S levels of ``msm.lane_fold``): every split of S L
gives the same MSM bit for bit.  ``lanes`` picks (L, S) from the card.
Kernel wrappers: ``dense_window_sums`` (``csrc/dense.cu``; its plain
version ``dense_window_sums_plain`` here).  The multiples are built once
per staged query by ``build_tables`` (``ec_add``).

Layouts (l32; E = (8,) for G1, (8, 2) for G2):
  tables x, y, z: (K, *E, M, n) int32, K = 8 (radix 16) or 3 (radix 4)
  digits: (W, M, n) int8
  per-lane sums: (*E, M, W, L) int32
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import ec, field as F, msm as MSM
from ._build import kernel, library

MULTIPLES = {16: 8, 4: 3}   # radix -> table entries {1P..KP}
BITS = {16: 4, 4: 2}        # radix -> window width
DTB = 128                   # csrc/dense.cu DTB: threads (lanes x segments)
                            # of a block
# Per field (G1, G2): the launch's threads, WAVES times what the card
# holds at once (its SMs x the kernel's resident blocks an SM x DTB), and
# the lane fold's width, segments taking the rest.  Chosen by
# tools/torch_dense_sweep.py at the 2^13 shapes (PERF.md): G1 runs best
# at 512 one-segment lanes, ~2.6 waves of 3 blocks an SM; in G2 a
# segmented block ends in its fold's adds, which a second wave pays
# again, and the lane fold at 128 lanes costs a third of 512's.
WAVES = {False: 3, True: 1}
FOLD_LANES = {False: 512, True: 128}
# the plain version on the CPU takes the H100's split: 132 SMs at the
# kernels' resident blocks (3 in G1, 2 in G2); any split gives the same
# MSM
CPU_SLOTS = {False: 132 * 3, True: 132 * 2}


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


def lanes(M: int, n: int, radix: int, is_g2: bool,
          slots: int) -> tuple[int, int]:
    """(L, S): lanes a window and segments a lane for M MSMs of n points
    on a card that holds `slots` blocks at once.  S L is the largest
    power of two <= n with M W S L <= WAVES * slots * DTB threads (at
    least 1); L = min(S L, FOLD_LANES), S the rest (at most DTB)."""
    W = MSM.WINDOWS[BITS[radix]]
    P = 1
    while 2 * P <= n and 2 * P * M * W <= WAVES[is_g2] * slots * DTB:
        P *= 2
    S = min(P // min(P, FOLD_LANES[is_g2]), DTB)
    return min(P // S, MSM.FOLD_MAX_LANES), S


_RESIDENT: dict = {}


def resident_blocks(radix: int, is_g2: bool, device) -> int:
    """Blocks of the window-sum kernel one SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor in csrc/dense.cu),
    asked once per kernel and device."""
    key = (radix, is_g2, torch.device(device))
    nb = _RESIDENT.get(key)
    if nb is None:
        fn = library("dense").dense_resident_blocks
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
        with torch.cuda.device(key[2]):
            nb = fn(int(is_g2), int(radix == 4))
        if nb <= 0:
            raise RuntimeError(f"dense_resident_blocks: CUDA error {-nb}")
        _RESIDENT[key] = nb
    return nb


def plan(tabs: DenseTables) -> tuple[int, int]:
    """(L, S) for the staged tables on their device."""
    dev = tabs.x.device
    slots = (CPU_SLOTS[tabs.is_g2] if dev.type == "cpu" else
             MSM.sm_count(dev) * resident_blocks(tabs.radix, tabs.is_g2, dev))
    return lanes(tabs.m, tabs.n, tabs.radix, tabs.is_g2, slots)


# -- the kernel and its plain version ------------------------------------------

DENSE = {(16, False): kernel("dense_window_sums_g1", "dense", "pppppppiiii"),
         (16, True): kernel("dense_window_sums_g2", "dense", "pppppppiiii"),
         (4, False): kernel("dense4_window_sums_g1", "dense", "pppppppiiii"),
         (4, True): kernel("dense4_window_sums_g2", "dense", "pppppppiiii")}


def dense_window_sums_plain(tabs: DenseTables, d: torch.Tensor, L: int,
                            S: int = 1):
    """The kernel's sums on l16 tensors: the per-lane loop over chunks of
    S L points, then fold-half levels from S L lanes down to L."""
    is_g2 = tabs.is_g2
    fld = ec.field_of(is_g2)
    ne = ec.elem_axes(is_g2)
    W, M, n = d.shape
    P = L * S                       # lanes of the loop: S L
    C = -(-n // P)
    pad = C * P - n
    d = torch.nn.functional.pad(d.to(torch.int64), (0, pad))
    # (K, *E, M, C*P) -> (*E, M, K, C*P): the multiple next to the columns
    tab = [torch.nn.functional.pad(t, (0, pad)).movedim(0, ne + 1)
           for t in (tabs.x, tabs.y, tabs.z)]
    acc = ec.identity_like(
        torch.empty(tab[0].shape[:ne] + (M, W, P), dtype=torch.int32,
                    device=d.device), is_g2)
    for c in range(C):
        dc = d[:, :, c * P:(c + 1) * P].permute(1, 0, 2)   # (M, W, P)
        k = (dc.abs().clamp(min=1) - 1).expand(tab[0].shape[:ne] + dc.shape)
        sel = [torch.gather(t[..., c * P:(c + 1) * P], ne + 1, k)
               for t in tab]
        y = F.unpack(sel[1])
        sel[1] = F.pack(fld.where(dc < 0, fld.neg(y), y))
        new = ec.ec_add_plain(acc, sel, is_g2)
        keep = (dc == 0).view((1,) * ne + tuple(dc.shape))
        acc = tuple(torch.where(keep, a, b) for a, b in zip(acc, new))
    while P > L:   # segment s += segment s + h
        P //= 2
        acc = ec.ec_add_plain(tuple(c[..., :P] for c in acc),
                              tuple(c[..., P:] for c in acc), is_g2)
    return acc


def dense_window_sums(tabs: DenseTables, d: torch.Tensor, L: int,
                      S: int = 1):
    """Per-lane window sums: tables (K, *E, M, n), digits (W, M, n) int8
    -> projective (*E, M, W, L), S segments a lane (a power of two up to
    DTB)."""
    if tabs.x.device.type == "cpu":
        return dense_window_sums_plain(tabs, d, L, S)
    is_g2, radix = tabs.is_g2, tabs.radix
    K, M, n = tabs.x.shape[0], tabs.m, tabs.n
    E = (8, 2) if is_g2 else (8,)
    W = MSM.WINDOWS[BITS[radix]]
    if (any(t.shape != (K,) + E + (M, n) or t.dtype != torch.int32
            for t in (tabs.x, tabs.y, tabs.z))
            or d.shape != (W, M, n) or d.dtype != torch.int8
            or L < 1 or L > n or S < 1 or S > DTB or S & (S - 1)):
        raise ValueError("dense_window_sums: bad table/digit shapes or "
                         "types, lanes or segments")
    outs = [torch.empty(E + (M, W, L), dtype=torch.int32, device=d.device)
            for _ in range(3)]
    DENSE[(radix, is_g2)](tabs.x.contiguous(), tabs.y.contiguous(),
                          tabs.z.contiguous(), d.contiguous(), *outs, M, n, L,
                          S)
    return tuple(outs)


def msm_dense(tabs: DenseTables, scalars: torch.Tensor):
    """M same-size MSMs over staged multiples.

    scalars: (16, M, n) plain 16-bit limbs (int tensor).  Returns
    projective Montgomery leaves (*E, M)."""
    radix = tabs.radix
    acc = dense_window_sums(tabs, digits(scalars, radix), *plan(tabs))
    return MSM.horner_windows(MSM.lane_fold(acc, tabs.is_g2), tabs.is_g2,
                              BITS[radix])
