#!/usr/bin/env python3
"""The dense MSM's window sums (dense_window_sums_g1 / _g2) timed on one
CUDA card, for any checkout of za_tpu_torch, at the 2^13 rung's shapes
(g1x4: G1, M = 4, n = 16384; b2: G2, M = 1, n = 16384) and at n = 1024
(the first 1024 points of each), where n caps the lanes.

    python3 tools/torch_dense_sweep.py [--root DIR] [--no-stages]
                                       [--no-sweep] [--out FILE]

--root: the checkout whose za_tpu_torch is measured (default: this
repository); the inputs are this repository's chip_smoke.py
(chain_inputs at 2^13, staged by the package's GpuEngine).  A package
without segments (S) runs its window sums at its own lanes() with S = 1.

Prints JSON lines, times in ms (stages in s):
  {"stages": {...}}: each 2^13 MSM of one prove split into its steps
    (chip_smoke.msm_breakdowns), alone ("sync") and back to back
    ("inline"), median of 3;
  {"default": [...]}: at each shape the package's own (L, S), the window
    sums' device time and the MSM span's (window sums + lane fold +
    Horner, back to back), exact against dense_window_sums_plain;
  {"sweep": [...]}: where the package's csrc/dense.cu builds variants
    (-DZA_DENSE_VARIANT), every variant (register cap MINB, products:
    Ops, OpsB3Mul = x9 by a product, OpsCall = products as calls,
    OpsCallFq = Fq2 products over calls of the Fq product) at
    every (L, S) of the grid, each exact against the plain version and
    its span's MSM equal to the default's at the same S L; with the
    variant's registers, spills and resident warps an SM, adds a thread
    (n / (S L)) and the (L, S) the package's lanes() picks for it; a
    package without variants sweeps L at S = 1;
  {"ptxas": {...}}: the package's dense kernels' registers and spills;
then the card's name and power limit.  Kernel times are device times
(chip_smoke.device_ms), medians of 5.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (MINB, products) of the variants, per field (False: G1, True: G2)
VARIANTS = {False: [(1, "Ops"), (1, "OpsB3Mul"), (1, "OpsCall"), (4, "Ops"),
                    (5, "Ops")],
            True: [(1, "Ops"), (1, "OpsCall"), (1, "OpsCallFq"),
                   (3, "OpsCallFq"), (4, "OpsCallFq"), (4, "OpsCall")]}
LANES = (64, 128, 256, 512)
PRODUCTS = {16384: (128, 256, 512, 1024, 2048), 1024: (64, 128, 256, 512,
                                                       1024)}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(_build, root: Path) -> dict:
    """{(is_g2, MINB, ops): (ctypes lib, ptxas log)}: one nvcc per
    variant, all started together."""
    src = root / "za_tpu_torch" / "csrc" / "dense.cu"
    out = _build.BUILD_ROOT / "dense_sweep" / _build._digest()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for g2, variants in VARIANTS.items():
        for minb, ops in variants:
            tag = f"{'g2' if g2 else 'g1'}_{minb}_{ops}"
            lib = out / f"lib{tag}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DZA_DENSE_VARIANT",
                   f"-DZA_DV_F={'Fq2' if g2 else 'Fq'}",
                   f"-DZA_DV_MINB={minb}", f"-DZA_DV_OPS={ops}", "-o",
                   str(lib), str(src)]
            log = out / f"{tag}.log"
            procs.append(((g2, minb, ops), lib, log, subprocess.Popen(
                cmd, stdout=open(log, "w"), stderr=subprocess.STDOUT)))
    libs = {}
    for key, lib, log, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n"
                               + log.read_text()[-4000:])
        cdll = ctypes.CDLL(str(lib))
        cdll.dense_variant.restype = ctypes.c_int
        cdll.dense_variant.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        cdll.dense_variant_blocks.restype = ctypes.c_int
        libs[key] = (cdll, log.read_text())
    return libs


def shapes(torch, cs):
    """[(where, tables, scalars)] at 2^13 and their first 1024 points."""
    from za_tpu_torch.engine.engine import GpuEngine

    inp = cs.chain_inputs(cs.LOG2N_DENSE)
    eng = GpuEngine()
    staged = eng.stage_params(inp["params"], inp["r1cs"])
    z_l = eng.witness_limbs_dev(inp["z"])
    h = eng.h_coeffs_limbs(inp["r1cs"], z_l, inp["domain"])
    ni = inp["r1cs"].num_inputs
    out = []
    for tag, tabs, scal in cs.msm_queries(staged, z_l, h, ni):
        out.append((f"2^13 {tag}", tabs, eng._scalars(tabs, scal)))
    for where, tabs, sc in list(out):
        cut = type(tabs)(*(c[..., :1024].contiguous()
                           for c in (tabs.x, tabs.y, tabs.z)),
                         is_g2=tabs.is_g2)
        out.append((where.replace("2^13", "n=1024"), cut,
                    sc[..., :1024].contiguous()))
    return out, (eng, staged, z_l, h, ni)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--no-stages", action="store_true")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--out", help="also write every line's JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_dense_sweep: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.setrecursionlimit(100_000)
    cs = load_smoke()
    from za_tpu_torch.engine import _build, ec, msm as MSM
    from za_tpu_torch.engine import msm_dense as MD

    cs.log(f"package {Path(_build.__file__).resolve().parent.parent}")
    t0 = time.time()
    _build.build_all()
    cs.legacy_dense_api(MD)
    has_variants = "ZA_DENSE_VARIANT" in (
        root / "za_tpu_torch" / "csrc" / "dense.cu").read_text()
    libs = build_variants(_build, root) if (
        has_variants and not args.no_sweep) else {}
    cs.log(f"built in {time.time() - t0:.1f}s")
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    cases, (eng, staged, z_l, h, ni) = shapes(torch, cs)
    if not args.no_stages:
        t = cs.median_split(lambda: cs.msm_breakdowns(
            torch, eng, staged, z_l, h, ni, sync=False))
        t.update({f"{k}.sync": v for k, v in cs.median_split(
            lambda: cs.msm_breakdowns(torch, eng, staged, z_l, h, ni,
                                      sync=True)).items()})
        emit({"stages": t})

    def span(run, g2):
        """window sums + lane fold + Horner, as msm_dense runs them"""
        return lambda: MSM.horner_windows(MSM.lane_fold(run(), g2), g2, 4)

    default, sweep = [], []
    for where, tabs, sc in cases:
        g2, n, M = tabs.is_g2, tabs.n, tabs.m
        d = MD.digits(sc, 16)
        L, S = MD.plan(tabs)
        plain = {}   # S L -> the plain per-lane sums at S L lanes

        def want(L, S):
            P = L * S
            if P not in plain:
                plain[P] = MD.dense_window_sums_plain(tabs, d, P, 1)
            acc = plain[P]
            while acc[0].shape[-1] > L:
                k = acc[0].shape[-1] // 2
                acc = ec.ec_add_plain(tuple(c[..., :k] for c in acc),
                                      tuple(c[..., k:] for c in acc), g2)
            return acc

        def check(got, L, S, what):
            assert all(torch.equal(a, b) for a, b in
                       zip(got, want(L, S))), f"{where} {what} L={L} S={S}"

        run = lambda: MD.dense_window_sums(tabs, d, L, S)  # noqa: E731
        check(run(), L, S, "default")
        msm = {L * S: span(run, g2)()}
        row = {"where": where, "L": L, "S": S, "adds_a_thread": n / (L * S),
               "ms": cs.device_ms(torch, run),
               "span_ms": cs.device_ms(torch, span(run, g2))}
        default.append(row)
        cs.log(f"default {row}")
        if args.no_sweep:
            continue
        if not libs:   # no variants: the package's kernel at S = 1
            todo = [(None, L_, 1) for L_ in LANES if L_ <= n]
        else:
            todo = [(key, L_, P // L_) for key in libs if key[0] == g2
                    for P in PRODUCTS[n] for L_ in LANES
                    if L_ <= P and P // L_ <= MD.DTB and P <= n]
        for key, L_, S_ in todo:
            if key is None:
                vrun = (lambda L_=L_: MD.dense_window_sums(tabs, d, L_))
                info = {"variant": "package"}
            else:
                lib, log = libs[key]
                blocks = lib.dense_variant_blocks()
                info = {"minb": key[1], "ops": key[2],
                        "warps_per_sm": blocks * MD.DTB // 32,
                        **cs.ptxas_usage(log, "_ZN2za17dense_sums_kernel"),
                        "lanes_pick": MD.lanes(
                            M, n, 16, g2,
                            MSM.sm_count(tabs.x.device) * blocks)}

                def vrun(lib=lib, L_=L_, S_=S_):
                    E = (8, 2) if g2 else (8,)
                    outs = [torch.empty(E + (M, 64, L_), dtype=torch.int32,
                                        device="cuda") for _ in range(3)]
                    rc = lib.dense_variant(
                        *(t.data_ptr() for t in (tabs.x, tabs.y, tabs.z, d,
                                                 *outs)),
                        M, n, L_, S_, torch.cuda.current_stream().cuda_stream)
                    assert rc == 0, f"dense_variant: CUDA error {rc}"
                    return tuple(outs)
            check(vrun(), L_, S_, str(info))
            out = span(vrun, g2)()
            P = L_ * S_
            if P in msm:   # every split of S L: the same MSM, bit for bit
                assert all(torch.equal(a, b) for a, b in zip(out, msm[P]))
            else:
                msm[P] = out
            r = {"where": where, "L": L_, "S": S_, "adds_a_thread": n / P,
                 **info, "ms": cs.device_ms(torch, vrun),
                 "span_ms": cs.device_ms(torch, span(vrun, g2))}
            sweep.append(r)
            cs.log(f"sweep {r}")
        best = min((r for r in sweep if r["where"] == where),
                   key=lambda r: r["span_ms"], default=None)
        cs.log(f"{where}: best span {best}")
    emit({"default": default})
    if sweep:
        emit({"sweep": sweep})
    log_text = (_build.build_dir() / "dense.log").read_text()
    usage = {}
    for name, prefix in (
            ("dense_window_sums_g1",
             "_ZN2za17dense_sums_kernelINS_2FpINS_7QParamsEEELb1E"),
            ("dense_window_sums_g2", "_ZN2za17dense_sums_kernelINS_3Fq2ELb1E"),
            ("dense4_window_sums_g1",
             "_ZN2za17dense_sums_kernelINS_2FpINS_7QParamsEEELb0E"),
            ("dense4_window_sums_g2",
             "_ZN2za17dense_sums_kernelINS_3Fq2ELb0E")):
        usage[name] = cs.ptxas_usage(log_text, prefix)
    emit({"ptxas": usage})
    card = cs.card_line()
    emit({"card": card})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
