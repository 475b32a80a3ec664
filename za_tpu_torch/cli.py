"""``za`` command-line interface: compile / setup / prove / test / verify.

Mirrors the reference CLI surface and defaults (cli/src/main.rs:25-33,
107-179), with a ``verify`` subcommand.  ``setup`` and ``prove`` run on
the card by default (``--engine gpu``: ``GpuEngine`` on CUDA; without a
card they exit with an error, they do not fall back to the host) or,
with ``--engine host``, on the exact host code.

    python3 -m za_tpu_torch.cli setup --verifiertype json
    python3 -m za_tpu_torch.cli prove
    python3 -m za_tpu_torch.cli verify
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from .compiler import Evaluator, Mode, optimize
from .compiler.tester import dump_error, run_embedded_tests

DEFAULT_CIRCUIT = "circuit.za"
DEFAULT_PROVING_KEY = "proving.key"
DEFAULT_INPUT = "input.json"
DEFAULT_PROOF = "proof.json"
DEFAULT_VERIFIER_SOLIDITY = "verifier.sol"
DEFAULT_VERIFIER_JSON = "verifier.json"


def _engine(name: str):
    if name == "host":
        return None
    from .engine.engine import GpuEngine

    return GpuEngine()  # raises without a CUDA card


def cmd_compile(args):
    log = logging.getLogger("za_tpu_torch")
    ev = Evaluator(Mode.GEN_CONSTRAINTS)
    start = time.monotonic()
    try:
        ev.eval_file(".", args.circuit)
    except Exception as err:
        dump_error(ev, repr(err))
        return 1
    log.info("Compile time: %.3fs", time.monotonic() - start)
    print(f"[compile] {len(ev.signals)} signals, {len(ev.constraints)} constraints")
    if args.print:
        for n in range(len(ev.signals)):
            print(f"{n}: {ev.signals.to_string(n)}")
        for n in range(len(ev.constraints)):
            from .algebra import Value

            print(f"{n}: {ev.signals.format(Value(ev.constraints.get(n)))}=0")
    start = time.monotonic()
    constraints, removed = optimize(ev.constraints, ev.signals.main_input_ids())
    log.info("Optimization time: %.3fs", time.monotonic() - start)
    print(
        f"[optimized] {len(ev.signals) - len(removed)} signals, "
        f"{len(constraints)} constraints"
    )
    return 0


def cmd_setup(args):
    from .groth16 import helper

    verifier = helper.setup(args.circuit, args.pk, args.verifiertype,
                            engine=_engine(args.engine))
    verifier_file = args.verifier or (
        DEFAULT_VERIFIER_SOLIDITY
        if args.verifiertype == "solidity"
        else DEFAULT_VERIFIER_JSON
    )
    with open(verifier_file, "w") as f:
        f.write(verifier)
    print(f"proving key written to {args.pk}")
    print(f"verifier written to {verifier_file}")
    return 0


def cmd_prove(args):
    from .groth16 import format as fmt
    from .groth16 import helper

    with open(args.input) as f:
        inputs = fmt.flatten_json("main", f.read())
    proof = helper.prove(args.pk, inputs, engine=_engine(args.engine))
    with open(args.proof, "w") as f:
        f.write(proof)
    print(f"proof written to {args.proof}")
    return 0


def cmd_test(args):
    try:
        run_embedded_tests(
            ".",
            args.circuit,
            debug=args.debug,
            skip_compile=args.skipcompile,
            output_witness=args.outputwitness,
            test_prefix=args.prefix,
        )
    except Exception as err:
        print(f"Error: {err!r}")
        return 1
    return 0


def cmd_verify(args):
    from .groth16 import helper

    with open(args.verifier) as f:
        vk_json = f.read()
    with open(args.proof) as f:
        proof_json = f.read()
    ok = helper.verify(vk_json, proof_json)
    print("OK" if ok else "INVALID")
    return 0 if ok else 1


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="za", description="za zk-SNARK toolchain (PyTorch and CUDA)"
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("compile", help="Only compile the circuit")
    p.add_argument("--circuit", default=DEFAULT_CIRCUIT)
    p.add_argument("--print", action="store_true")
    p.set_defaults(fn=cmd_compile)

    engine_help = ("gpu (default): the CUDA card, an error without one; "
                   "host: the exact host code")
    p = sub.add_parser("setup", help="Compile & generate trusted setup")
    p.add_argument("--circuit", default=DEFAULT_CIRCUIT)
    p.add_argument("--pk", default=DEFAULT_PROVING_KEY)
    p.add_argument("--verifier", default=None)
    p.add_argument("--verifiertype", default="solidity", choices=["solidity", "json"])
    p.add_argument("--engine", default="gpu", choices=["gpu", "host"],
                   help=engine_help)
    p.set_defaults(fn=cmd_setup)

    p = sub.add_parser("prove", help="Generate a proof")
    p.add_argument("--pk", default=DEFAULT_PROVING_KEY)
    p.add_argument("--input", default=DEFAULT_INPUT)
    p.add_argument("--proof", default=DEFAULT_PROOF)
    p.add_argument("--engine", default="gpu", choices=["gpu", "host"],
                   help=engine_help)
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("test", help="Run embedded circuit tests")
    p.add_argument("--circuit", default=DEFAULT_CIRCUIT)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--outputwitness", action="store_true")
    p.add_argument("--skipcompile", action="store_true")
    p.add_argument("--prefix", default="")
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("verify", help="Verify a proof against verifier.json")
    p.add_argument("--verifier", default=DEFAULT_VERIFIER_JSON)
    p.add_argument("--proof", default=DEFAULT_PROOF)
    p.set_defaults(fn=cmd_verify)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    sys.setrecursionlimit(100_000)
    try:
        return args.fn(args)
    except FileNotFoundError as err:
        print(f"error: {err.filename}: no such file", file=sys.stderr)
        return 1
    except Exception as err:  # noqa: BLE001 -- CLI boundary
        if args.verbose:
            raise
        print(f"error: {err}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
