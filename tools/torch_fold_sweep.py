#!/usr/bin/env python3
"""The tail of the port's MSMs (the tree's chunk carry and the lane fold
of both routes) timed on one CUDA card, for any checkout of
za_tpu_torch: inside each MSM of one prove at 2^17 (tree) and 2^13
(dense), and alone at the carry's shapes, with the variants of the
carry and the fold.

    python3 tools/torch_fold_sweep.py [--root DIR] [--no-stages]
                                      [--no-kernels] [--fold-sweep]
                                      [--chunks 5,8,64,128]

--root: the checkout whose za_tpu_torch is measured (default: this
repository); the inputs and the step split are this repository's
chip_smoke.py (chain_inputs, msm_breakdowns).  A package whose carry
runs a launch a chunk runs it that way (chip_smoke.legacy_carry_api).

Prints JSON lines, CUDA-event times in seconds (stages) or ms:
  {"stages": {rung: {step: s}}}: each MSM of one prove split into its
    steps, each step alone ("sync", a host sync after it) and back to
    back inside the stage ("inline", one sync), median of 3, with the
    stage's span ("{tag}.total"); with --fold-sweep, "g2_fold_widths":
    the G2 lane fold inline on staged adds of 8, 16 and 32 lanes from
    the variant build, then the package's own again;
  {"carry": [...]}: at each 2^17 MSM's (M, W = 64, T = 128) and C
    chunks of random partials (a tenth flagged at infinity): the
    package's carry ("ms"; a launch a chunk: the old kernel launched C
    times, "launches": C) and the carry and the lane fold back to back
    ("tail_ms"), exact against the package's plain version; where the
    package has the carry a MSM, its plan ("plan": columns, warps) and
    every variant (columns a block, warps, levels one add a thread or
    staged, the G2 staged add's lanes from a build of csrc/ec.cu with
    -DZA_EC_VARIANTS), each exact;
  {"fold_sweep": [...]} with --fold-sweep: ec_fold at each MSM's shape
    under the package's plan ("default", with "plan": windows a block,
    blocks a window, warps, widest staged level) and, where the package
    has msm.fold_plan, every variant (windows a block, blocks a window,
    warps, levels one add a thread or staged, the G2 staged add's lanes
    from the variant build), each exact against lane_fold_plain; a
    checkout before fold_plan times its default alone;
  {"fold_depth": [...]} with --fold-sweep, where the package has
    fold_plan: the fold under each shape's plan at 1, 2, 4, .. L lanes
    (G2 also with one width on every level): the fixed cost and each
    level's;
  {"ptxas": {...}}: registers and spill bytes of the curve kernels and
    of the variant build's G2 carries and folds;
then the card's name and power limit.  Kernel times are medians of 5,
of the device alone (chip_smoke.device_ms).  Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (group is G2, M, W, L): the lane fold of each MSM of a proof
FOLD_SHAPES = [
    (False, 3, 64, 128, "2^17 g1abl"), (False, 1, 64, 128, "2^17 g1h"),
    (True, 1, 64, 128, "2^17 b2"), (False, 4, 64, 512, "2^13 g1x4"),
    (True, 1, 64, 128, "2^13 b2"), (False, 4, 127, 256, "2^13 fused g1x4"),
    (True, 1, 127, 128, "2^13 fused b2")]
CARRY_SHAPES = FOLD_SHAPES[:3]
# chunks of each 2^17 MSM's carry (g1abl and b2: nv a little past 2^17)
TREE_CHUNKS = {"2^17 g1abl": 5, "2^17 g1h": 8, "2^17 b2": 5}
# the fold's variants: windows a block, blocks a window (a cluster),
# warps, the widest level run staged (G1; wider ones one add a thread),
# G2's staged lanes (of the fold and the carry)
FOLD_B = (1, 2, 3, 4, 6, 8, 12, 16)
FOLD_K = (1, 2, 4, 8)
WARPS = (4, 8, 16)
FOLD_WIDE = (0, 16, 32, 64, 128, 256, 1 << 30)
G2_WIDTHS = (8, 16, 32)
# the carry's variants: columns a block, warps, staged levels (and G2
# lanes, G2_WIDTHS)
CARRY_COLS = (4, 8, 16, 32, 64, 128)
CARRY_WARPS = (2, 4, 8, 16)
SMEM = 232448   # bytes of shared memory a block may take
SLOTS = {False: 25, True: 90}   # hw1::SLOTS, hw2::SLOTS


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(_build, root: Path):
    """csrc/ec.cu with -DZA_EC_VARIANTS -> (ctypes lib, ptxas log), or
    (None, None) where the package has no such variants."""
    src = root / "za_tpu_torch" / "csrc" / "ec.cu"
    if "ZA_EC_VARIANTS" not in src.read_text():
        return None, None
    out = _build.BUILD_ROOT / "ec_variants" / _build._digest()
    out.mkdir(parents=True, exist_ok=True)
    lib, log = out / "libec_variants.so", out / "ec_variants.log"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DZA_EC_VARIANTS", "-o",
           str(lib), str(src)]
    with open(log, "w") as out_log:
        rc = subprocess.run(cmd, stdout=out_log,
                            stderr=subprocess.STDOUT).returncode
    if rc:
        raise RuntimeError("nvcc failed:\n" + log.read_text()[-4000:])
    cdll = ctypes.CDLL(str(lib))
    for name, ints in (("ec_carry_g2_width", 6), ("ec_fold_g2_width", 7)):
        if hasattr(cdll, name):   # the fold's since fold_plan
            fn = getattr(cdll, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * ints
                           + [ctypes.c_void_p])
    return cdll, log.read_text()


def stages(torch, cs, MSM, var) -> dict:
    from za_tpu_torch.engine.engine import GpuEngine

    out = {}
    for log2n in (cs.LOG2N, cs.LOG2N_DENSE):
        inp = cs.chain_inputs(log2n)
        eng = GpuEngine()
        staged = eng.stage_params(inp["params"], inp["r1cs"])
        z_l = eng.witness_limbs_dev(inp["z"])
        h = eng.h_coeffs_limbs(inp["r1cs"], z_l, inp["domain"])
        ni = inp["r1cs"].num_inputs

        def split(sync):
            return cs.median_split(lambda: cs.msm_breakdowns(
                torch, eng, staged, z_l, h, ni, sync=sync))

        rung = {}
        for sync in (True, False):
            rung.update({f"{k}.{'sync' if sync else 'inline'}": v
                         for k, v in split(sync).items()})
        if var is not None and hasattr(var, "ec_fold_g2_width"):
            rung["g2_fold_widths"] = g2_fold_widths(torch, MSM, var, split)
        out[f"2^{log2n}"] = rung
        cs.log(f"stages 2^{log2n}: {rung}")
    return out


def g2_fold_widths(torch, MSM, var, split) -> dict:
    """The G2 lane fold inside its stage (inline ms, the steps back to
    back) on staged adds of each of G2_WIDTHS' lanes from the variant
    build, under the package's plan, then the package's own kernel
    again."""
    own, out = MSM.FOLD[True], {}

    class Width:   # MSM.FOLD[True]'s interface on the variant build
        def __init__(self, width):
            self.width = width

        def __call__(self, *args):
            rc = var.ec_fold_g2_width(
                *(a.data_ptr() for a in args[:6]), *args[6:], self.width,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"ec_fold_g2_width: CUDA error {rc}")

    try:
        for width in G2_WIDTHS + (None,):
            MSM.FOLD[True] = own if width is None else Width(width)
            out["package" if width is None else str(width)] = {
                k: v for k, v in split(False).items()
                if k.endswith(".lane_fold")}
    finally:
        MSM.FOLD[True] = own
    return out


def carry_rows(torch, cs, gen, chunks, var) -> list:
    """The "carry" line (module docstring)."""
    from za_tpu_torch.engine import cuda_tree as CT, msm as MSM

    per_msm = "carry_plan" in vars(CT)
    rows = []
    for (g2, M, W, T, where), C in itertools.product(CARRY_SHAPES, chunks):
        E = (2,) if g2 else ()
        x, y = (cs.rand_fq(torch, (C,) + E + (M, W, T), gen).movedim(
            0, 1).contiguous() for _ in "xy")
        inf = torch.rand((C, M, W, T), generator=gen, device="cuda") < 0.1
        if per_msm:
            want = CT.chunk_carry_plain(x, y, inf, g2)
        else:   # the package's own plain version, chunk by chunk
            want = None
            for c in range(C):
                want = CT.chunk_carry_plain(want, x[c], y[c], inf[c], g2)
        got = CT.chunk_carry(x, y, inf, g2)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), where
        row = {"where": where, "C": C, "M": M, "launches": 1 if per_msm
               else C, "ms": cs.device_ms(
                   torch, lambda: CT.chunk_carry(x, y, inf, g2)),
               "tail_ms": cs.device_ms(torch, lambda: MSM.lane_fold(
                   CT.chunk_carry(x, y, inf, g2), g2))}
        if per_msm:
            row["plan"] = CT.carry_plan(C, M * W * T, g2, x.device)
            row["variants"] = carry_variants(torch, cs, CT, var, x, y,
                                             inf, want, g2)
            best = min(row["variants"], key=lambda r: r["ms"])
            cs.log(f"carry {where} C={C}: {row['ms']:.4f} ms, best {best}")
            cs.log(json.dumps(row))
        else:
            cs.log(f"carry {where} C={C}: {row['ms']:.4f} ms in {C} "
                   f"launches")
        rows.append(row)
    return rows


def carry_variants(torch, cs, CT, var, x, y, inf, want, g2) -> list:
    """Every (columns, warps, levels one add a thread, G2 lanes) that
    fits shared memory, each exact."""
    C, M, W, T = inf.shape
    N = M * W * T
    P = 1 << (C - 1).bit_length()
    out = [torch.empty_like(want[0]) for _ in range(3)]
    default = 32 // CT.CARRY_PER_WARP[True] if g2 else 6
    if g2:   # G2's thread adds lost everywhere (128 registers, spills)
        grid = [(cols, warps, 1 << 30, width) for cols, warps, width
                in itertools.product(CARRY_COLS, CARRY_WARPS, G2_WIDTHS
                                     if var is not None else (default,))]
    else:    # wide: every level one add a thread, the last one or two
        grid = [(cols, warps, wide, 6) for cols, warps in
                itertools.product(CARRY_COLS, CARRY_WARPS)
                for wide in (0, cols, 2 * cols, 1 << 30)]
    rows, seen = [], set()
    for cols, warps, wide, width in grid:
        levels = [cols * P >> k for k in range(1, max(P.bit_length(), 1))]
        threads = sum(h > wide for h in levels)   # levels one add a thread
        units = 32 // width if g2 else 5
        smem = 32 * (C * cols * (6 if g2 else 3) + (
            warps * units * SLOTS[g2] if threads < len(levels) else 0))
        key = (cols, warps, threads, width)
        if smem > SMEM or N % cols or key in seen:
            continue   # does not fit, or the same variant
        seen.add(key)

        def launch():
            args = [x, y, inf, *out, C, N, cols, wide, warps]
            if width == default:
                CT.CARRY[g2](*args)
                return
            rc = var.ec_carry_g2_width(
                *(a.data_ptr() for a in args[:6]), *args[6:], width,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"ec_carry_g2_width: CUDA error {rc}")

        launch()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), key
        rows.append({"cols": cols, "warps": warps, "thread_levels": threads,
                     "levels": len(levels), "width": width,
                     "ms": cs.device_ms(torch, launch)})
    return rows


def fold_variants(G: int, L: int, g2: bool):
    """(B windows a block, K blocks a window, warps, widest staged level,
    G2 lanes) that fit shared memory, one per distinct schedule (the
    same levels one add a thread; G2 runs no thread add)."""
    seen = set()
    for B, K, warps, wide, width in itertools.product(
            FOLD_B, FOLD_K, WARPS, (1 << 30,) if g2 else FOLD_WIDE,
            G2_WIDTHS if g2 else (6,)):
        if G % B or K > L:
            continue
        lanes = max(L // K, K) * B
        levels = [h for h in (lanes >> k for k in range(1, 20)) if h >= B]
        threads = sum(h > wide for h in levels)
        units = 32 // width if g2 else 5
        scratch = (warps * units * SLOTS[g2] * 32
                   if threads < len(levels) or not threads else 0)
        key = (B, K, warps, threads, width)
        if lanes * (192 if g2 else 96) + scratch > SMEM or key in seen:
            continue
        seen.add(key)
        yield B, K, warps, wide, width, threads, len(levels)


def in_place(torch, cs, CT, gen, where, g2, M, W, L):
    """fn -> {"ms": its device ms} and, at a 2^17 shape, in place behind
    the MSM's carry: "after_carry_ms", both launches' device time less
    the carry's alone, and "inline_ms", CUDA events around fn issued
    after the carry, as chip_smoke's msm_inline_s times a step (host
    gaps included; median of 5)."""
    if where not in TREE_CHUNKS:
        return lambda fn: {"ms": cs.device_ms(torch, fn)}
    C, E = TREE_CHUNKS[where], (2,) if g2 else ()
    x, y = (cs.rand_fq(torch, (C,) + E + (M, W, L), gen).movedim(
        0, 1).contiguous() for _ in "xy")
    inf = torch.rand((C, M, W, L), generator=gen, device="cuda") < 0.1

    def carry():
        CT.chunk_carry(x, y, inf, g2)

    def inline(fn):
        out = []
        for _ in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            carry()
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out[1:])

    alone = cs.device_ms(torch, carry)
    return lambda fn: {"ms": cs.device_ms(torch, fn), "after_carry_ms":
                       cs.device_ms(torch, lambda: (carry(), fn())) - alone,
                       "inline_ms": inline(fn)}


def fold_sweep(torch, cs, MSM, CT, gen, var) -> list:
    """ec_fold at each shape: the package's own plan ("default"), and
    where the package has fold_plan every variant of fold_variants, each
    exact (G2's other lanes from the variant build); at the 2^17 shapes
    also in place, queued behind the MSM's carry (TREE_CHUNKS chunks of
    random partials): "after_carry_ms", the two launches' device time
    less the carry's alone."""
    sweep = []
    planned = hasattr(MSM, "fold_plan")
    for g2, M, W, L, where in FOLD_SHAPES:
        E = (2,) if g2 else ()
        pts = [cs.rand_fq(torch, E + (M, W, L), gen) for _ in range(3)]
        want = MSM.lane_fold_plain(pts, g2)
        got = MSM.lane_fold(pts, g2)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), where
        timed = in_place(torch, cs, CT, gen, where, g2, M, W, L)
        row = {"where": where, "default": True,
               **timed(lambda: MSM.lane_fold(pts, g2))}
        if planned:
            row["plan"] = MSM.fold_plan(M * W, L, g2, pts[0].device)
        sweep.append(row)
        cs.log(f"fold {where}: {row}")
        if not planned:
            continue   # a checkout before fold_plan: its default alone
        out = [torch.empty_like(want[0]) for _ in range(3)]
        for B, K, warps, wide, width, threads, levels in fold_variants(
                M * W, L, g2):
            if g2 and var is None:
                continue   # G2's variants need the variant build

            def launch():
                args = [*pts, *out, M * W, L, B, K, wide, warps]
                if not g2:
                    MSM.FOLD[g2](*args)
                    return
                rc = var.ec_fold_g2_width(
                    *(a.data_ptr() for a in args[:6]), *args[6:], width,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"ec_fold_g2_width: CUDA error {rc}")

            launch()
            key = (where, B, K, warps, wide, width)
            assert all(torch.equal(a, b) for a, b in zip(out, want)), key
            sweep.append({"where": where, "B": B, "K": K, "warps": warps,
                          "thread_levels": threads, "levels": levels,
                          "width": width, **timed(launch)})
        best = min((r for r in sweep if r["where"] == where
                    and "B" in r), key=lambda r: r["ms"])
        cs.log(f"fold {where}: best {best}")
    return sweep


def fold_depth(torch, cs, MSM, gen, var) -> list:
    """ec_fold at each shape's windows under its plan (and, in G2, the
    plan on staged adds of 8, 16 or 32 lanes) at L' = 1, 2, 4, .. L
    lanes, K = min(K, L'): the launch's fixed cost (L' = 1: load and
    store, no level) and what each level adds."""
    rows = []
    for g2, M, W, L, where in FOLD_SHAPES:
        E = (2,) if g2 else ()
        pts = [cs.rand_fq(torch, E + (M, W, L), gen) for _ in range(3)]
        B, K, warps, wide = MSM.fold_plan(M * W, L, g2, pts[0].device)
        # the plan's lanes, and in G2 each width of the variant build
        for width in (None,) + (G2_WIDTHS if g2 and var is not None
                               else ()):
            ms = {}
            for k in range(L.bit_length()):
                n = 1 << k
                sub = [c[..., :n].contiguous() for c in pts]
                out = [torch.empty_like(sub[0][..., 0]) for _ in range(3)]
                args = [*sub, *out, M * W, n, B, min(K, n), wide, warps]
                if width is None:
                    fn = lambda a=args: MSM.FOLD[g2](*a)   # noqa: E731
                else:
                    fn = lambda a=args: var.ec_fold_g2_width(  # noqa: E731
                        *(t.data_ptr() for t in a[:6]), *a[6:], width,
                        torch.cuda.current_stream().cuda_stream)
                fn()
                assert all(torch.equal(a, b) for a, b in zip(
                    out, MSM.lane_fold_plain(sub, g2))), (where, n, width)
                ms[n] = cs.device_ms(torch, fn)
            rows.append({"where": where, "plan": (B, K, warps, wide),
                         "width": width, "ms_at_lanes": ms})
            cs.log(f"fold depth {where} width {width}: {ms}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--no-stages", action="store_true")
    ap.add_argument("--no-kernels", action="store_true",
                    help="the stages alone, no kernel-level lines")
    ap.add_argument("--fold-sweep", action="store_true")
    ap.add_argument("--chunks", default="5,8,64,128")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_fold_sweep: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.setrecursionlimit(100_000)
    cs = load_smoke()
    from za_tpu_torch.engine import _build, cuda_tree as CT
    from za_tpu_torch.engine import msm as MSM, msm_dense as MD

    cs.log(f"package {Path(_build.__file__).resolve().parent.parent}")
    _build.build_all()
    cs.legacy_dense_api(MD)
    cs.legacy_carry_api(CT)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    var, var_log = ((None, None) if args.no_kernels and not args.fold_sweep
                    else build_variants(_build, root))
    if not args.no_stages:
        print(json.dumps({"stages": stages(torch, cs, MSM,
                                           var if args.fold_sweep
                                           else None)}), flush=True)
    if args.no_kernels:
        print(cs.card_line())
        return 0
    chunks = [int(c) for c in args.chunks.split(",")]
    print(json.dumps({"carry": carry_rows(torch, cs, gen, chunks, var)}),
          flush=True)
    if args.fold_sweep:
        print(json.dumps({"fold_sweep": fold_sweep(torch, cs, MSM, CT, gen,
                                                   var)}), flush=True)
        if hasattr(MSM, "fold_plan"):
            print(json.dumps({"fold_depth": fold_depth(torch, cs, MSM, gen,
                                                       var)}), flush=True)

    usage = {}
    variants = {}   # the variant build's staged G2 carries and folds
    for w in G2_WIDTHS:
        for fold, tag in ((0, "carry"), (1, "fold")):
            variants[f"ec_{tag}_g2_w{w}"] = (
                f"_ZN2za13ec_sum_kernelINS_3Fq2ELi{w}ELb0ELb{fold}E")
    for log_text, names in (((_build.build_dir() / "ec.log").read_text(),
                             cs.KERNEL_FN), (var_log, variants)):
        for name, prefix in names.items():
            if log_text and (name.startswith("ec_")
                             or name.startswith("horner_")):
                try:
                    usage[name] = cs.ptxas_usage(log_text, prefix)
                except AssertionError:
                    usage[name] = None   # not in this package's build
    print(json.dumps({"ptxas": usage}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
