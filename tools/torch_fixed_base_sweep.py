#!/usr/bin/env python3
"""The trusted setup's window tables and the Horner kernels of any
checkout on one CUDA card, each held exactly against its plain version.

    python3 tools/torch_fixed_base_sweep.py [--root DIR] [--c 8,13,16]
        [--variants] [--out FILE]

--root DIR runs the za_tpu_torch package of another checkout (an older
commit unpacked with git archive): its kernels are built from its own
csrc/.  One JSON line a row:

  horner: horner_g1 (radix 16, M = 3) and horner_g2 (radix 16, M = 1) on
      random window sums at the 2^17 proof's W = 64: "device_ms" (one
      call queued behind a sleep kernel, median of 5), "us_per_add" (one
      MSM's chain of 5 W complete adds), ptxas registers and spill, and
      a digest of the kernel's SASS ("sass_sha1": equal digests on two
      checkouts mean the same code);
  sass: the digest of every kernel of csrc/ec.cu (Horner, the lane fold
      and the chunk carry among them);
  table: fixed_base_table of G1 and G2 (the generator) at each c
      (default 8, the setup's): "device_ms", "issue_ms" (5 calls back to
      back), "chain_floor_ms" (254 doublings x this run's Horner
      "us_per_add") and the ratio to it; where the checkout's
      engine/fixed_base.py has the ladder and the windows as wrappers of
      their own, "ladder_ms" and "windows_ms", each exact against its
      plain version; the registers and spill of every kernel of
      csrc/fixed_base.cu;
  variant (--variants, on a checkout with those wrappers): csrc/
      fixed_base.cu built with a text patch, the window levels on one
      complete add a thread (curve.cuh's point_add on mul in G1, on
      Karatsuba over mul_eo in G2; levels 0 .. 7 in one launch of 128
      threads a window, each level above a launch) in place of the
      staged add a warp: its windows after the package's ladder at c =
      8, exact against the plain windows, alone ("windows_ms") and with
      the ladder ("device_ms"), with the variant's registers and spill.
Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# the window levels on one complete add a thread, the text patch of
# --variants: this kernel for fixed_base_levels_kernel, and its launches
THREAD_LEVELS = r"""// Levels k0 .. k1 - 1 of every window from D, one complete add a
// thread (curve.cuh's point_add), gridDim.x / W blocks a window.
constexpr int TL_TB = 128;
constexpr int TL_BLOCK_LEVELS = 8;
template <class F>
__global__ void fixed_base_levels_kernel(const uint32_t* __restrict__ DX,
                                         const uint32_t* __restrict__ DY,
                                         const uint32_t* __restrict__ DZ,
                                         uint32_t* __restrict__ TX,
                                         uint32_t* __restrict__ TY,
                                         uint32_t* __restrict__ TZ, int c,
                                         int W, int k0, int k1) {
  using O = std::conditional_t<sizeof(F) == sizeof(Fq), Ops, OpsEo>;
  const int n = min(c * W, FB_LADDER);
  const size_t entries = (size_t)W << c;
  const unsigned per = gridDim.x / W;
  const int w = blockIdx.x / per;
  const unsigned t = (blockIdx.x % per) * blockDim.x + threadIdx.x;
  const unsigned nt = per * blockDim.x;
  const size_t e0 = (size_t)w << c;
  F ax, ay, az;
  if (k0 == 0 && t == 0) {
    set_identity(ax, ay, az);
    store(TX, entries, e0, ax);
    store(TY, entries, e0, ay);
    store(TZ, entries, e0, az);
  }
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const unsigned h = 1u << k;
    const int j = c * w + k;
    const bool past = j >= n;
#pragma unroll 1
    for (unsigned i = t; i < h; i += nt) {
      if (past && i == 0) {
        set_identity(ax, ay, az);
      } else if (past || i > 0) {
        load(ax, TX, entries, e0 + i);
        load(ay, TY, entries, e0 + i);
        load(az, TZ, entries, e0 + i);
      }
      if (!past) {
        F bx, by, bz;
        load(bx, DX, (size_t)n, (size_t)j);
        load(by, DY, (size_t)n, (size_t)j);
        load(bz, DZ, (size_t)n, (size_t)j);
        if (i == 0) {
          ax = bx;
          ay = by;
          az = bz;
        } else {
          point_add<F, O>(ax, ay, az, bx, by, bz, ax, ay, az);
        }
      }
      store(TX, entries, e0 + h + i, ax);
      store(TY, entries, e0 + h + i, ay);
      store(TZ, entries, e0 + h + i, az);
    }
    if (k + 1 < k1) __syncthreads();
  }
}

"""


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(obj, out) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def ptxas_all(log_text: str, smoke) -> dict:
    """{entry function: {"regs", "spill_bytes"}} of a ptxas -v log."""
    names = re.findall(r"Compiling entry function '(\S+)'", log_text)
    return {fn: smoke.ptxas_usage(log_text, fn) for fn in names}


def horner_rows(torch, smoke, sass, out) -> dict:
    """The Horner rows; -> {"g1": us_per_add, "g2": ...}."""
    from za_tpu_torch.engine import _build, msm as MSM

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    log = (_build.build_dir() / "ec.log").read_text()
    digests = sass(_build.build_dir() / "libec.so")
    us = {}
    for is_g2, M in ((False, 3), (True, 1)):
        g = "g2" if is_g2 else "g1"
        W, bits = 64, 4
        E = (2,) if is_g2 else ()
        wsum = tuple(smoke.rand_fq(torch, E + (M, W), gen) for _ in range(3))
        _, ms, pms, err = smoke.compare(
            torch, f"horner_{g}",
            lambda *a: MSM.horner_windows(a, is_g2, bits),
            lambda *a: MSM.horner_windows_plain(a, is_g2, bits), wsum)
        fn = smoke.KERNEL_FN[f"horner_{g}"]
        us[g] = float(ms) * 1e3 / ((bits + 1) * W)
        emit({"section": "horner", "name": f"horner_{g}", "M": M, "W": W,
              "device_ms": float(ms), "issue_ms": ms.issue,
              "plain_ms": pms, "max_abs_err": err, "us_per_add": us[g],
              **smoke.ptxas_usage(log, fn),
              "sass_sha1": [v for k, v in digests.items()
                            if k.startswith(fn)]}, out)
    emit({"section": "sass", "source": "ec.cu", "digests": digests}, out)
    return us


def table_rows(torch, smoke, cs, us, out) -> None:
    from za_tpu_torch.curve import G1_GEN, G2_GEN
    from za_tpu_torch.engine import _build, ec, fixed_base as FB

    usage = ptxas_all((_build.build_dir() / "fixed_base.log").read_text(),
                      smoke)
    for c in cs:
        for is_g2 in (False, True):
            g = "g2" if is_g2 else "g1"
            base = ec.points_to_device([G2_GEN if is_g2 else G1_GEN],
                                       is_g2, "cuda")
            tab, ms, pms, err = smoke.compare(
                torch, f"fixed_base_table_{g}",
                lambda *b: FB.fixed_base_table(b, c, is_g2),
                lambda *b: FB.fixed_base_table_plain(b, c, is_g2), base,
                reps=3)
            floor = (FB.LADDER - 1) * us[g] / 1e3
            row = {"section": "table", "name": f"fixed_base_table_{g}",
                   "c": c, "device_ms": float(ms), "issue_ms": ms.issue,
                   "plain_ms": pms, "max_abs_err": err,
                   "chain_floor_ms": floor, "floor_ratio": float(ms) / floor}
            if hasattr(FB, "fixed_base_ladder"):
                lad = FB.fixed_base_ladder(base, c, is_g2)
                assert all(torch.equal(x, y) for x, y in zip(
                    lad, FB.fixed_base_ladder_plain(base, c, is_g2)))
                assert all(torch.equal(x, y) for x, y in zip(
                    FB.fixed_base_windows(lad, c, is_g2), tab))
                row.update(ladder_ms=smoke.device_ms(
                    torch, lambda: FB.fixed_base_ladder(base, c, is_g2)),
                    windows_ms=smoke.device_ms(
                        torch, lambda: FB.fixed_base_windows(lad, c, is_g2)))
            emit(row, out)
    emit({"section": "ptxas", "source": "fixed_base.cu", "usage": usage}, out)


def thread_levels_source(text: str) -> str:
    """csrc/fixed_base.cu with the window levels on a thread's add."""
    start = text.index("// Levels k0 .. k1 - 1 of every window from D")
    end = text.index("    if (k + 1 < k1) __syncthreads();\n  }\n}\n", start)
    end = text.index("}\n}\n", end) + 4
    body = text[:start] + THREAD_LEVELS + text[end:]
    a = body.index("int launch_levels(")
    b = body.index("  return (int)cudaGetLastError();", a)
    launch = (body[a:b].replace("FB_BLOCK_LEVELS", "TL_BLOCK_LEVELS")
              .replace("32 * FB_WARPS", "TL_TB"))
    assert launch.count("TL_BLOCK_LEVELS") == 2 and "TL_TB" in launch
    return "#include <type_traits>\n" + body[:a] + launch + body[b:]


def variant_rows(torch, smoke, sweep, tmp: Path, out) -> None:
    """The thread-add window levels (THREAD_LEVELS) at c = 8, in one
    launch through the variant library's entry point, after the
    package's ladder; exact against the plain windows."""
    from za_tpu_torch.curve import G1_GEN, G2_GEN
    from za_tpu_torch.engine import _build, ec, fixed_base as FB

    if not hasattr(FB, "fixed_base_ladder"):
        smoke.log("variants: the checkout's table has no ladder wrapper")
        return
    src = tmp / "fixed_base_thread_levels.cu"
    src.write_text(thread_levels_source(
        (_build.CSRC / "fixed_base.cu").read_text()))
    lib_path = tmp / "libfixed_base_thread_levels.so"
    proc = sweep.nvcc_build(src, lib_path, [], _build.CSRC)
    log = proc.communicate()[0]
    assert proc.returncode == 0, log[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    c, W = 8, FB.windows(8)
    for is_g2 in (False, True):
        g = "g2" if is_g2 else "g1"
        base = ec.points_to_device([G2_GEN if is_g2 else G1_GEN], is_g2,
                                   "cuda")
        lad = FB.fixed_base_ladder(base, c, is_g2)
        want = FB.fixed_base_windows_plain(lad, c, is_g2)
        fn = getattr(lib, f"fixed_base_levels_{g}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        tab = [torch.empty_like(x) for x in want]

        def windows(d=lad):
            rc = fn(*(x.data_ptr() for x in (*d, *tab)), c, W, 0, c,
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"variant levels: CUDA error {rc}"

        windows()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(tab, want)), g
        emit({"section": "variant", "variant": "thread_levels",
              "name": f"fixed_base_levels_{g}", "c": c, "max_abs_err": 0,
              "windows_ms": smoke.device_ms(torch, windows),
              "device_ms": smoke.device_ms(torch, lambda: windows(
                  FB.fixed_base_ladder(base, c, is_g2))),
              **smoke.ptxas_usage(log, smoke.KERNEL_FN[
                  f"fixed_base_levels_{g}"])}, out)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--c", default="8", help="table windows, comma list")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_fixed_base_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from za_tpu_torch.engine import _build

    assert Path(_build.__file__).resolve().is_relative_to(
        args.root.resolve()), "the checkout's package was not imported"
    built = _build.build_all()
    smoke = load("chip_smoke_fb", HERE / "chip_smoke.py")
    sweep = load("hpipe_sweep_fb", HERE / "tools" / "torch_hpipe_sweep.py")
    smoke.log(f"{args.root}: built {built}")
    name = smoke.card_line()
    emit({"section": "card", "card": name, "root": str(args.root),
          "torch": torch.__version__, "cuda": torch.version.cuda}, args.out)
    us = horner_rows(torch, smoke, sweep.sass_digests, args.out)
    table_rows(torch, smoke, [int(c) for c in args.c.split(",")], us,
               args.out)
    if args.variants:
        variant_rows(torch, smoke, sweep, Path(tempfile.mkdtemp(
            prefix="fixed_base_sweep_")), args.out)
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
