#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference in the prover's place with one guarantee broken, judged as a
run's proofs are.

    python3 prover_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--proofs N] [--bits 253]

For each seed it makes the cell's inputs as a run does, draws the
window's first N (witness, r, s) in a run's order, makes each proof
with every witness value cut to ``--bits`` bits in the witness MSMs
(the scalars a short window count would leave), and prints the numbers
the run compares (wrong A, B, C) as one JSON line a seed.  The
benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from prover_bench import inputs  # noqa: E402
from prover_bench.reference.groth16 import (  # noqa: E402
    Expected, control_proofs, judge)
from prover_bench.run import Cell  # noqa: E402


def readings(cell: Cell, seed: int, proofs: int, bits: int) -> dict:
    circuit = cell.generator.rows(cell.config)
    W = inputs.pool_size(cell.traffic, len(circuit["a"]))
    ws = inputs.witness_pool(cell.generator, cell.config, seed, W)
    exp = Expected(circuit, inputs.proving_key_logs(seed))
    rs = inputs.Randomness(seed)
    draws = [(i % W, *rs.next()) for i in range(proofs)]
    ctl = control_proofs(exp, ws, draws, (1 << bits) - 1)
    return {f"wrong_{k}": v for k, v in judge(exp, ws, ctl).items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--proofs", type=int, default=32)
    p.add_argument("--bits", type=int, default=253)
    args = p.parse_args(argv)
    cell = Cell(HERE.parent, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        out = readings(cell, seed, args.proofs, args.bits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "proofs": args.proofs, "bits": args.bits, **out,
                          "seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
