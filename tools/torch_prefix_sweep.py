#!/usr/bin/env python3
"""Variants of the port's ntt_prefix_fr kernel (za_tpu_torch/csrc/ntt.cu)
timed side by side on one CUDA card, each held exactly against the plain
version.

Each variant is a copy of csrc/ntt.cu with one or two lines replaced
(values a thread, lanes a block, the Montgomery product of the
butterflies called rather than inlined, the block's register cap), built
by its own nvcc
(all at once) into a temporary directory and bound with ctypes.  Every
variant runs the 2^18 sub-NTT shape (3 x 512 x 512, m_fuse 512) with no
mode and with each mode, in turns; CUDA-event times, median of 5 rounds
of 10 launches after a warm-up.  Registers and spills come from each
build's ptxas log.  Run from the repository root:

    python3 tools/torch_prefix_sweep.py [variant ...]

Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LANES_LINE = "constexpr int PREFIX_BLOCK_LANES = 4;"
EL_LINE = "constexpr int PREFIX_LOG_EL = 2;"
BUTTERFLY = "  const Fr vt = mul(v, w);"
NOINLINE = """__device__ __noinline__ Fr mul_call(const Fr& a, const Fr& b) {
  return mul(a, b);
}

__device__ __forceinline__ void butterfly("""
BOUNDS = "__global__ void __launch_bounds__(PREFIX_TB)\nntt_prefix_kernel("


def lanes(n):
    return (LANES_LINE, f"constexpr int PREFIX_BLOCK_LANES = {n};")


def values(n):
    return (EL_LINE, f"constexpr int PREFIX_LOG_EL = {n.bit_length() - 1};")


def blocks(n):
    return (BOUNDS, f"__global__ void __launch_bounds__(PREFIX_TB, {n})\n"
                    "ntt_prefix_kernel(")


CALL = [("__device__ __forceinline__ void butterfly(", NOINLINE),
        (BUTTERFLY, "  const Fr vt = mul_call(v, w);")]

# name -> [(old, new)] replacements in csrc/ntt.cu: values a thread
# (el), lanes a block, blocks an SM asked of ptxas, the product called.
# The shared-memory swizzle is the kernel's (made for el4, lanes4).
VARIANTS = {
    "el4_lanes4": [],
    "el4_lanes4_2blocks": [blocks(2)],
    "el4_lanes2": [lanes(2)],
    "el4_lanes2_4blocks": [lanes(2), blocks(4)],
    "el4_lanes8": [lanes(8)],
    "el2_lanes4": [values(2)],
    "el8_lanes8": [values(8), lanes(8)],
    "el8_lanes4": [values(8)],
    "el8_lanes2": [values(8), lanes(2)],
    "el8_lanes8_call": [values(8), lanes(8), *CALL],
    "el8_lanes4_3blocks": [values(8), blocks(3)],
}


def build(names, out: Path) -> dict:
    from za_tpu_torch.engine import _build

    src = (_build.CSRC / "ntt.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    usage = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log[-3000:]
        part = log.split("Compiling entry function '_ZN2za17ntt_prefix")[1]
        usage[name] = {
            "regs": int(re.search(r"Used (\d+) registers", part).group(1)),
            "spill": [int(v) for v in re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                part).groups()]}
    return usage


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_prefix_sweep: no CUDA device", file=sys.stderr)
        return 2
    from za_tpu_torch.engine import field as F, ntt as NTT

    names = argv or list(VARIANTS)
    tmp = Path(tempfile.mkdtemp(prefix="prefix_sweep_"))
    usage = build(names, tmp)
    fns = {}
    for name in names:
        fn = getattr(ctypes.CDLL(str(tmp / f"lib{name}.so")), "ntt_prefix_fr")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fns[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(5)
    limbs = torch.randint(0, 1 << 16, (16, 3, 512, 512), generator=gen,
                          dtype=torch.int64, device="cuda")
    limbs[15] %= 0x3064                   # canonical mod r
    x = F.pack(limbs)
    dom = NTT.DeviceDomain(1 << 18, "cuda")
    tw = dom.fourstep.t2_fwd
    x1 = x[:, :1].contiguous()
    cases = {"plain": (x, 0, 3), "scale_in": (x, 1, 3),
             "combine": (x, 2, 1), "scale_out": (x1, 4, 1)}
    stream = torch.cuda.current_stream().cuda_stream
    results = {name: {"ms": {}, **usage[name]} for name in names}
    for mode, (xin, flag, B) in cases.items():
        kw = {"scale_in": dom.coset_pow} if flag == 1 else {}
        if flag == 2:
            kw = {"combine": True}
        if flag == 4:
            kw = {"scale_out": dom.h_out}
        want = NTT.ntt_prefix_plain(xin, tw, 512, **kw)
        out = torch.empty_like(want)

        def launch(fn):
            rc = fn(xin.data_ptr(), out.data_ptr(), tw.data_ptr(),
                    dom.coset_pow.data_ptr(), dom.h_out.data_ptr(), B, 512, 512,
                    512, flag, stream)
            assert rc == 0, rc

        times = {name: [] for name in names}
        for name in names:
            out.zero_()
            launch(fns[name])
            torch.cuda.synchronize()
            assert torch.equal(out, want), (name, mode)
        for _ in range(5):
            for name in names + names[::-1]:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(10):
                    launch(fns[name])
                b.record()
                torch.cuda.synchronize()
                times[name].append(a.elapsed_time(b) / 10)
        for name in names:
            results[name]["ms"][mode] = statistics.median(times[name])
    for name in names:
        print(json.dumps({"variant": name, **results[name]}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
