#!/usr/bin/env python3
"""Time one card's prove of any checkouts in turns: the device compute of
the chain at 2^LOG2N constraints (chip_smoke.py's prove_path, lean: h(x)
and the five MSMs, CUDA events, one warm-up, median of 3), each run a
process of its own with that checkout first on sys.path, its kernels
built into the checkout's own _build/.

    python3 tools/torch_prove_ab.py --root PARENT --root . --root . \\
        --root PARENT [--log2n 17]

Prints one JSON line per run and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = """
import json, os, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
from za_tpu_torch.engine import _build
_build.build_all()
res, _, _ = cs.prove_path(torch, cs.Timer(torch), {log2n}, lean=True)
print(json.dumps({{k: res[k] for k in ("value", "runs_s", "stages_s",
                                        "stage_s", "route")}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout; give each as often as it should run")
    ap.add_argument("--log2n", type=int, default=17)
    args = ap.parse_args()
    for root in args.root:
        root = os.path.abspath(root)
        p = subprocess.run([sys.executable, "-c",
                            RUN.format(root=root, log2n=args.log2n)],
                           cwd=root, capture_output=True, text=True,
                           timeout=1200)
        if p.returncode != 0:
            print(p.stderr[-4000:], file=sys.stderr)
            return p.returncode
        line = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, **line}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
