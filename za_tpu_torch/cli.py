"""``za`` command-line interface: compile / setup / prove / test / verify.

Mirrors the reference CLI surface and defaults (cli/src/main.rs:25-33,
107-179), with a ``verify`` subcommand.  ``setup`` and ``prove`` run on
the card by default (``--engine gpu``: ``GpuEngine`` on CUDA; without a
card they exit with an error, they do not fall back to the host) or,
with ``--engine host``, on the exact host code.

    python3 -m za_tpu_torch.cli setup --verifiertype json
    python3 -m za_tpu_torch.cli prove
    python3 -m za_tpu_torch.cli verify

``-v`` logs each step's seconds and, unless ``ZA_METRICS`` is already
set, turns on the engine's per-stage lines (``[stage] <name>: <wall>s
device <dev>s``, engine/metrics.py) and a line a proof, ``[proof]
id=<n> wall=<s>s syncs=<n> h2d=<MB>MB d2h=<MB>MB launches=<n>
witness_native=<n> witness_fallback=<n>`` (the host's waits for the
card, the bytes copied each way, the kernel launches, the witness values
converted natively or in Python).

Several cards (``--mesh N`` on setup and prove, default ``$ZA_MESH``):
with ``ZA_DIST="host:port,nprocs,procid"`` or torchrun's variables set
the process is one rank of that group (N, if given, must be its size);
without them ``--mesh N`` starts N local ranks itself (spawned, one a
card, each running the same command).  Every rank proves; rank 0
writes the proof.  The setup is not sharded: rank 0 runs it on its
card and writes the pk, the other ranks wait for it.

    python3 -m za_tpu_torch.cli prove --mesh 2
    ZA_DIST=10.0.0.1:29500,2,0 python3 -m za_tpu_torch.cli prove
"""

from __future__ import annotations

import argparse
import logging
import os
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


def _mesh_default() -> int:
    """$ZA_MESH parsed defensively: the default is evaluated at parser
    build time, so a malformed value must not crash unrelated
    subcommands with a traceback."""
    raw = os.environ.get("ZA_MESH", "0")
    try:
        return int(raw)
    except ValueError:
        print(f"warning: ignoring non-integer ZA_MESH={raw!r}",
              file=sys.stderr)
        return 0


def _engine(name: str, mesh: int = 0):
    """The engine of --engine and --mesh: None for the host; GpuEngine
    (raises without a CUDA card), over the group of ZA_DIST or
    torchrun's variables where they are set."""
    if name == "host":
        if mesh:
            raise SystemExit("--mesh requires --engine gpu")
        return None
    from .engine import dist

    spec = dist.dist_spec()
    if spec is not None:
        if mesh and mesh != spec[1]:
            raise SystemExit(f"--mesh {mesh}: the group of this process "
                             f"has {spec[1]} ranks")
        dist.init_distributed()
        mesh = spec[1]
    from .engine.engine import GpuEngine

    return GpuEngine(mesh=mesh if mesh > 1 else None)


def _in_group() -> bool:
    from .engine.dist import dist_spec

    return dist_spec() is not None


def _rank_main(argv: list, n: int, rank: int, port: int) -> None:
    """One of the local ranks of ``--mesh N``: the same command, as rank
    `rank` of a group of n on this host, on card `rank`."""
    os.environ.update(ZA_DIST=f"127.0.0.1:{port},{n},{rank}",
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    sys.exit(main(argv))


def _run_ranks(argv: list, n: int) -> int:
    """--mesh N without a group: on a card (one a rank), the kernels
    built here, then N local ranks, spawned, each running argv; when one
    fails the others are stopped.  -> the first failing rank's exit
    code, or 0."""
    import multiprocessing.connection

    import torch
    import torch.multiprocessing as mp

    from .engine import dist

    if torch.cuda.is_available():
        from .engine import _build

        dist.need_cards(n)      # one rank a card
        _build.build_all()      # once, here: the ranks only load
    ctx = mp.get_context("spawn")
    port = dist.free_port()
    procs = [ctx.Process(target=_rank_main, args=(argv, n, r, port))
             for r in range(n)]
    for p in procs:
        p.start()
    rc, live = 0, list(procs)
    try:
        while live:
            multiprocessing.connection.wait([p.sentinel for p in live])
            for p in [p for p in live if p.exitcode is not None]:
                live.remove(p)
                if p.exitcode and not rc:
                    rc = p.exitcode if p.exitcode > 0 else 1
                    for q in live:
                        q.terminate()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return rc


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

    engine = _engine(args.engine, args.mesh)
    mesh = getattr(engine, "mesh", None)
    if mesh is not None and mesh.rank:
        # the setup is not sharded: wait for rank 0's
        if not mesh.all_true(True):
            raise RuntimeError("rank 0's setup failed")
        return 0
    try:
        verifier = helper.setup(args.circuit, args.pk, args.verifiertype,
                                engine=engine)
    except BaseException:
        if mesh is not None:
            mesh.all_true(False)
        raise
    if mesh is not None:
        mesh.all_true(True)
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
    engine = _engine(args.engine, args.mesh)
    proof = helper.prove(args.pk, inputs, engine=engine)
    if getattr(engine, "rank", 0) == 0:
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
    mesh_help = ("shard the prove over N ranks, one a card (gpu engine; "
                 "default $ZA_MESH): the ranks of ZA_DIST or torchrun's "
                 "group, or N local ranks started here")
    p = sub.add_parser("setup", help="Compile & generate trusted setup")
    p.add_argument("--circuit", default=DEFAULT_CIRCUIT)
    p.add_argument("--pk", default=DEFAULT_PROVING_KEY)
    p.add_argument("--verifier", default=None)
    p.add_argument("--verifiertype", default="solidity", choices=["solidity", "json"])
    p.add_argument("--engine", default="gpu", choices=["gpu", "host"],
                   help=engine_help)
    p.add_argument("--mesh", type=int, metavar="N", default=_mesh_default(),
                   help=mesh_help)
    p.set_defaults(fn=cmd_setup)

    p = sub.add_parser("prove", help="Generate a proof")
    p.add_argument("--pk", default=DEFAULT_PROVING_KEY)
    p.add_argument("--input", default=DEFAULT_INPUT)
    p.add_argument("--proof", default=DEFAULT_PROOF)
    p.add_argument("--engine", default="gpu", choices=["gpu", "host"],
                   help=engine_help)
    p.add_argument("--mesh", type=int, metavar="N", default=_mesh_default(),
                   help=mesh_help)
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

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    if args.verbose and "ZA_METRICS" not in os.environ:
        # the engine's per-stage lines (engine/metrics.py); the variable
        # is read when the engine is imported, in _engine, after this
        os.environ["ZA_METRICS"] = "1"
    sys.setrecursionlimit(100_000)
    try:
        if (args.command in ("setup", "prove") and args.engine == "gpu"
                and args.mesh > 1 and not _in_group()):
            return _run_ranks(argv, args.mesh)
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
