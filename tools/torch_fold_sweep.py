#!/usr/bin/env python3
"""The tail of the port's MSMs (the tree's chunk carry and the lane fold
of both routes) timed on one CUDA card, for any checkout of
za_tpu_torch: inside each MSM of one prove at 2^17 (tree) and 2^13
(dense), and alone at every shape those proofs give it.

    python3 tools/torch_fold_sweep.py [--root DIR] [--no-stages]
                                      [--no-kernels]

--root: the checkout whose za_tpu_torch is measured (default: this
repository); the inputs and the step split are this repository's
chip_smoke.py (chain_inputs, msm_breakdowns).  A package without the
carry kernel runs its tail as it was written: the carry as
msm_tree.proj_of_affine plus one ec_add launch, the lane fold as one
ec_add launch per level on slices of the lanes.

Prints JSON lines, CUDA-event times in seconds (stages) or ms:
  {"stages": {rung: {step: s}}}: each MSM of one prove split into its
    steps, each step alone ("sync", a host sync after it) and back to
    back inside the stage ("inline", one sync), median of 3, with the
    stage's span ("{tag}.total");
  {"ec_add_at_tail_shapes": [...]}: ec_add alone on contiguous operands
    at the carry's shapes and at every level of each fold's;
  {"legacy_tail": [...]}: the carry and the fold as ec_add launches, as
    the package before the fold kernel ran them: with the host's time to
    issue them ("fold_ms", "carry_ms") and on the device alone
    ("fold_device_ms", "carry_device_ms"), with one sync a level
    ("fold_sync_ms");
  {"fold_sweep": [...]}, {"carry": [...]}: where the package has them,
    ec_fold at each shape under every (warps, widest staged level, blocks
    a window) variant and ec_carry at each carry shape, each exact
    against its plain version;
  {"ptxas": {...}}: registers and spill bytes of the curve kernels, from
    the build's ec.log;
then the card's name and power limit.  Kernel times are medians of 5,
of the device alone (chip_smoke.device_ms) where not said otherwise.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import statistics
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
WARPS = (4, 8, 16)
STAGED_MAX = (1 << 30, 64, 16)
SPLIT = (1, 2, 4, 8)


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def legacy_fold(p, is_g2):
    """The lane fold as the package before ec_fold ran it."""
    from za_tpu_torch.engine import ec

    while p[0].shape[-1] > 1:
        h = p[0].shape[-1] // 2
        p = ec.ec_add(tuple(c[..., :h] for c in p),
                      tuple(c[..., h:] for c in p), is_g2)
    return tuple(c[..., 0] for c in p)


def legacy_carry(acc, x, y, inf, is_g2):
    """The chunk carry as the package before ec_carry ran it."""
    from za_tpu_torch.engine import ec, msm_tree as MT

    p = MT.proj_of_affine(x, y, inf, is_g2)
    return p if acc is None else ec.ec_add(acc, p, is_g2)


def stages(torch, cs) -> dict:
    from za_tpu_torch.engine.engine import GpuEngine

    out = {}
    for log2n in (cs.LOG2N, cs.LOG2N_DENSE):
        inp = cs.chain_inputs(log2n)
        eng = GpuEngine()
        staged = eng.stage_params(inp["params"], inp["r1cs"])
        z_l = eng.witness_limbs_dev(inp["z"])
        h = eng.h_coeffs_limbs(inp["r1cs"], z_l, inp["domain"])
        ni = inp["r1cs"].num_inputs
        rung = {}
        for sync in (True, False):
            t = cs.median_split(lambda: cs.msm_breakdowns(
                torch, eng, staged, z_l, h, ni, sync=sync))
            rung.update({f"{k}.{'sync' if sync else 'inline'}": v
                         for k, v in t.items()})
        out[f"2^{log2n}"] = rung
        cs.log(f"stages 2^{log2n}: {rung}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--no-stages", action="store_true")
    ap.add_argument("--no-kernels", action="store_true",
                    help="the stages alone, no kernel-level lines")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_fold_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.setrecursionlimit(100_000)
    cs = load_smoke()
    from za_tpu_torch.engine import _build, cuda_tree as CT, ec
    from za_tpu_torch.engine import msm as MSM, msm_dense as MD

    cs.log(f"package {Path(_build.__file__).resolve().parent.parent}")
    _build.build_all()
    cs.legacy_dense_api(MD)
    if not hasattr(CT, "chunk_carry"):
        CT.chunk_carry = legacy_carry
    has_kernels = hasattr(MSM, "FOLD")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    timer = cs.Timer(torch)

    def host_ms(fn, reps=5):
        fn()
        return statistics.median(timer(fn)[1] for _ in range(reps)) * 1e3

    def points(g2, *shape):
        E = (2,) if g2 else ()
        return [cs.rand_fq(torch, E + shape, gen) for _ in range(3)]

    if not args.no_stages:
        print(json.dumps({"stages": stages(torch, cs)}), flush=True)
    if args.no_kernels:
        print(cs.card_line())
        return 0

    adds, legacy = [], []
    for g2, M, W, L, where in FOLD_SHAPES:
        n = M * W * L
        ns = [("carry", n)] if (g2, M, W, L, where) in CARRY_SHAPES else []
        ns += [(f"fold level h={h}", M * W * h)
               for h in (L >> k for k in range(1, L.bit_length())) if h]
        for step, k in ns:
            p, q = points(g2, k), points(g2, k)
            adds.append({"where": where, "step": step, "adds": k,
                         "ms": cs.device_ms(torch,
                                            lambda: ec.ec_add(p, q, g2))})
        pts = points(g2, M, W, L)
        per_level = 0.0
        while pts[0].shape[-1] > 1:   # the fold, one sync a level
            h = pts[0].shape[-1] // 2
            pts, dt = timer(lambda: ec.ec_add(
                tuple(c[..., :h] for c in pts), tuple(c[..., h:] for c in pts),
                g2))
            per_level += dt * 1e3
        pts = points(g2, M, W, L)
        row = {"where": where, "fold_ms": host_ms(
            lambda: legacy_fold(pts, g2)), "fold_device_ms": cs.device_ms(
            torch, lambda: legacy_fold(pts, g2)), "fold_sync_ms": per_level}
        if (g2, M, W, L, where) in CARRY_SHAPES:
            acc = points(g2, M, W, L)
            x, y = points(g2, M, W, L)[:2]
            inf = torch.rand((M, W, L), generator=gen, device="cuda") < 0.1
            row["carry_ms"] = host_ms(
                lambda: legacy_carry(acc, x, y, inf, g2))
            row["carry_device_ms"] = cs.device_ms(
                torch, lambda: legacy_carry(acc, x, y, inf, g2))
        legacy.append(row)
        cs.log(f"legacy tail {row}")
    print(json.dumps({"ec_add_at_tail_shapes": adds}), flush=True)
    print(json.dumps({"legacy_tail": legacy}), flush=True)

    if has_kernels:
        sweep, carry = [], []
        for g2, M, W, L, where in FOLD_SHAPES:
            pts = points(g2, M, W, L)
            want = MSM.lane_fold_plain(pts, g2)
            keep = (MSM.FOLD_WARPS[g2], MSM.FOLD_STAGED_MAX[g2],
                    MSM.fold_split)
            for warps, wide, split in itertools.product(WARPS, STAGED_MAX,
                                                        SPLIT):
                if wide < (1 << 30) and wide >= L // 2:
                    continue   # no level is wider: the same variant
                MSM.FOLD_WARPS[g2], MSM.FOLD_STAGED_MAX[g2] = warps, wide
                MSM.fold_split = lambda G, L, device, k=split: min(k, L)
                got = MSM.lane_fold(pts, g2)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    f"ec_fold {where} warps={warps} staged<={wide} {split}"
                sweep.append({"where": where, "warps": warps,
                              "staged_max": wide, "split": split,
                              "ms": cs.device_ms(
                                  torch, lambda: MSM.lane_fold(pts, g2)),
                              "host_ms": host_ms(
                                  lambda: MSM.lane_fold(pts, g2))})
            MSM.FOLD_WARPS[g2], MSM.FOLD_STAGED_MAX[g2], MSM.fold_split = keep
            sweep.append({"where": where, "default": True, "ms": cs.device_ms(
                torch, lambda: MSM.lane_fold(pts, g2))})
            best = min((r for r in sweep if r["where"] == where
                        and "default" not in r), key=lambda r: r["ms"])
            cs.log(f"fold {where}: best {best}")
        for g2, M, W, L, where in CARRY_SHAPES:
            acc = points(g2, M, W, L)
            x, y = points(g2, M, W, L)[:2]
            inf = torch.rand((M, W, L), generator=gen, device="cuda") < 0.1
            want = CT.chunk_carry_plain(acc, x, y, inf, g2)
            got = CT.chunk_carry([c.clone() for c in acc], x, y, inf, g2)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                f"ec_carry {where}"
            first = CT.chunk_carry(None, x, y, inf, g2)
            assert all(torch.equal(a, b) for a, b in zip(
                first, CT.chunk_carry_plain(None, x, y, inf, g2))), \
                f"ec_carry {where}, first chunk"
            carry.append({"where": where, "ms": cs.device_ms(
                torch, lambda: CT.chunk_carry(got, x, y, inf, g2)),
                "host_ms": host_ms(
                    lambda: CT.chunk_carry(got, x, y, inf, g2)),
                "first_ms": cs.device_ms(
                    torch, lambda: CT.chunk_carry(None, x, y, inf, g2))})
        print(json.dumps({"fold_sweep": sweep}), flush=True)
        print(json.dumps({"carry": carry}), flush=True)

    log_text = (_build.build_dir() / "ec.log").read_text()
    usage = {}
    for name, prefix in cs.KERNEL_FN.items():
        if name.startswith("ec_") or name.startswith("horner_"):
            try:
                usage[name] = cs.ptxas_usage(log_text, prefix)
            except AssertionError:
                usage[name] = None   # not in this package's build
    print(json.dumps({"ptxas": usage}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
