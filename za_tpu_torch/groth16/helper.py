"""End-to-end orchestration: setup() / prove() / verify().

The capability surface the ``za`` CLI (``za_tpu_torch.cli``) drives
(reference: prover/src/groth16/helper.rs:17-159).  ``prove`` takes the
engine the caller gives: ``GpuEngine`` (the card) or None (the exact
host engine).  With ``GpuEngine`` the pk's query vectors are parsed as
raw limb arrays and checked against the curve at staging, and the
staged tables are kept beside the pk in ``<pk>.gpucache`` for the next
process; the compiled witness program goes to ``<pk>.wtrace`` whatever
the engine.  Under a mesh (``GpuEngine(mesh=...)``) every rank proves
and keeps its own table cache; rank 0 alone writes the trace, and the
CLI has it alone write the proof.  ``setup`` takes an engine too: ``GpuEngine`` builds the
pk's queries on the card, None on the host.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from ..algebra import FS, Value
from ..compiler import Constraints, Evaluator, Mode, Signals, optimize
from ..compiler.tester import dump_error
from ..compiler.wtrace import (
    TraceMismatch, TraceRecorder, WitnessProgram, pk_digest,
)
from ..native import wtrace_lib
from . import format as fmt
from .ethereum import generate_solidity
from .prove import STAGED_MIN, prove as groth16_prove
from .r1cs import R1CS
from .setup import generate_parameters
from .verify import verify_proof

log = logging.getLogger("za_tpu_torch")

VERIFIER_SOLIDITY = "solidity"
VERIFIER_JSON = "json"

#: the staged-table cache beside a pk: GpuEngine's own, never the
#: reference engine's <pk>.devcache (that one holds another engine's
#: layout under a key without the engine in it)
GPUCACHE_SUFFIX = ".gpucache"


class WitnessRejected(RuntimeError):
    """The witness does not satisfy the circuit's constraints."""


def setup(
    circuit_path: str,
    proving_key_path: str,
    verifier_type: str = VERIFIER_SOLIDITY,
    engine=None,
) -> str:
    """Compile(GenConstraints) -> optimize -> trusted setup -> write pk;
    returns the verifier artifact text (helper.rs:22-89).  The setup's
    query points come from the engine (GpuEngine: the card) or, with
    None, the host."""
    ev = Evaluator(Mode.GEN_CONSTRAINTS)

    log.info("Compiling circuit...")
    start = time.monotonic()
    try:
        ev.eval_file(".", circuit_path)
    except Exception as err:
        dump_error(ev, repr(err))
        raise
    log.info("Compilation time: %.3fs", time.monotonic() - start)

    signals, constraints = ev.signals, ev.constraints
    log.info("[compile] %d signals, %d constraints", len(signals), len(constraints))

    start = time.monotonic()
    irreducible = signals.main_input_ids()
    constraints, removed_signals = optimize(constraints, irreducible)
    log.info("Optimization time: %.3fs", time.monotonic() - start)
    log.info(
        "[optimized] %d signals, %d constraints",
        len(signals) - len(removed_signals),
        len(constraints),
    )

    log.info("Running setup")
    start = time.monotonic()
    r1cs = R1CS.from_constraints(signals, constraints, removed_signals)
    params = generate_parameters(r1cs, engine=engine)
    log.info("Setup time: %.3fs (%s)", time.monotonic() - start,
             "host" if engine is None else "device")

    start = time.monotonic()
    with open(proving_key_path, "wb") as f:
        fmt.write_pk(
            f, ev.collected_asts, constraints, removed_signals, params,
            densities=r1cs.densities(),
        )
    log.info("Proving key write time: %.3fs", time.monotonic() - start)

    inputs = signals.main_public_input_names()
    if verifier_type == VERIFIER_SOLIDITY:
        return generate_solidity(params.vk, inputs)
    if verifier_type == VERIFIER_JSON:
        return fmt.vk_to_json(params.vk, inputs)
    raise ValueError(f"unknown verifier type {verifier_type}")


def prove(
    proving_key_path: str,
    inputs: list[tuple[str, FS]],
    engine=None,
    deterministic_rs: Optional[tuple[int, int]] = None,
    timings: Optional[dict] = None,
) -> str:
    """read pk -> witness (compiled trace replay, or GenWitness over the
    pk-stored ASTs on first run / trace divergence) -> prove -> proof.json
    (helper.rs:91-147).

    The interpreted run records a straight-line witness program, cached
    next to the pk (``<pk>.wtrace``, keyed on the pk's digest) and
    replayed for later proofs (compiler/wtrace.py); guard mismatches
    (input-dependent control flow) fall back to the interpreter.
    ``ZA_WTRACE=0`` turns the trace off, ``ZA_DEVCACHE=0`` the staged
    table cache.  ``timings``, when given, receives the seconds of each
    step (``pk_read_s``, ``digest_s``, ``wtrace_load_s``, ``witness_s``,
    ``wtrace_dump_s``, ``sat_check_s``, ``prove_s``, ``self_verify_s``,
    ``wall_s``) and how the witness was made (``witness``: "interpret",
    "replay_native" or "replay_python")."""
    t = timings if timings is not None else {}
    # engines with device staging read the query vectors as raw limb
    # arrays (vectorized parse; the curve check runs at staging)
    raw = (
        engine is not None
        and hasattr(engine, "stage_params")
        and getattr(engine, "use_grouped", False)
    )
    t_all = time.monotonic()
    start = time.monotonic()
    with open(proving_key_path, "rb") as f:
        pk = fmt.read_pk(f, raw_queries=raw)
    t["pk_read_s"] = time.monotonic() - start
    log.info("Proving key read time: %.3fs", t["pk_read_s"])

    def _done(proof_json: str) -> str:
        t["wall_s"] = time.monotonic() - t_all
        log.info(
            "prove wall time: %.3fs end to end (pk read -> witness -> "
            "prove -> self-verify)", t["wall_s"],
        )
        return proof_json

    use_wtrace = os.environ.get("ZA_WTRACE", "1") != "0"
    wtrace_path = proving_key_path + ".wtrace"
    use_cache = raw and os.environ.get("ZA_DEVCACHE", "1") != "0"
    start = time.monotonic()
    digest = (
        pk_digest(proving_key_path) if (use_wtrace or use_cache) else b""
    )
    t["digest_s"] = time.monotonic() - start
    if use_cache:
        # staged-table cache: stage_params loads the tables from
        # <pk>.gpucache (or saves them after the first staging)
        pk.params._gpucache_path = proving_key_path + GPUCACHE_SUFFIX
        pk.params._gpucache_digest = digest.hex()

    start = time.monotonic()
    prog = WitnessProgram.load(wtrace_path, digest) if use_wtrace else None
    t["wtrace_load_s"] = time.monotonic() - start
    if prog is not None:
        start = time.monotonic()
        try:
            # replay straight into the R1CS assignment (native C tape
            # interpreter when available): no Signals-store rebuild, no
            # per-prove R1CS reconstruction
            r1cs = _replay_r1cs(digest, prog, pk)
            z_limbs, z_head = prog.run_z(
                {name: fs.v for name, fs in inputs}, r1cs
            )
            t["witness_s"] = time.monotonic() - start
            t["witness"] = ("replay_native" if wtrace_lib() is not None
                            else "replay_python")
            log.info("Witness replay time: %.3fs (compiled trace)",
                     t["witness_s"])
        except TraceMismatch as exc:
            log.info("Witness trace diverged (%s); re-interpreting", exc)
            z_limbs = None
        if z_limbs is not None:
            # a replayed witness that fails the R1CS check (which the
            # guards should make impossible) falls back to the
            # interpreter instead of failing the proof; any other error
            # (the device's, the self-verification's) is raised
            try:
                return _done(generate_verified_proof_z(
                    r1cs, z_limbs, z_head, pk.params, engine=engine,
                    deterministic_rs=deterministic_rs, timings=t,
                ))
            except WitnessRejected as exc:
                log.warning("replayed witness rejected (%s); "
                            "re-interpreting", exc)

    log.info("Generating witness...")
    ev = Evaluator(Mode.GEN_WITNESS)
    if use_wtrace:
        ev.wtrace = TraceRecorder()
    start = time.monotonic()
    for signal, value in inputs:
        ev.set_deferred_value(signal, Value(value))
    ev.eval_asts(pk.asts)
    t["witness_s"] = time.monotonic() - start
    t["witness"] = "interpret"
    log.info("Witness generation time: %.3fs", t["witness_s"])

    if not ev.constraints.is_empty():
        raise RuntimeError("Constrains generated in witnes")

    log.info("Checking signals...")
    for n in range(1, len(ev.signals)):
        signal = ev.signals.get_by_id(n)
        if signal.value is None:
            raise RuntimeError(
                f"signal '{signal.full_name}' value is not defined"
            )

    if use_wtrace and prog is None and getattr(engine, "rank", 0) == 0:
        # keep an existing valid cache on guard divergence: a workload
        # alternating between input-dependent paths would otherwise
        # re-record and rewrite the cache on every prove; under a mesh
        # rank 0 writes it, the other ranks read it in later proves
        start = time.monotonic()
        try:
            ev.wtrace.finish(ev.signals).dump(wtrace_path, digest)
        except OSError as exc:  # read-only pk dir: skip the cache
            log.info("could not cache witness trace: %s", exc)
        t["wtrace_dump_s"] = time.monotonic() - start

    log.info("Creating and self-verifying proof...")
    return _done(generate_verified_proof(
        ev.signals, pk.ignore_signals, pk.constraints, pk.params,
        engine=engine, deterministic_rs=deterministic_rs, timings=t,
    ))


#: per-process replay R1CS cache: the variable layout and constraint
#: rows are pk-static, so repeat proves share one compiled R1CS
_replay_r1cs_cache: dict = {}


def _replay_r1cs(digest: bytes, prog, pk):
    key = digest.hex()
    r1cs = _replay_r1cs_cache.get(key)
    if r1cs is None:
        r1cs = R1CS.from_constraints(
            prog.meta_signals(), pk.constraints, pk.ignore_signals
        )
        _replay_r1cs_cache.clear()  # hold at most one pk's tables
        _replay_r1cs_cache[key] = r1cs
    return r1cs


def _z_ints(z_limbs) -> list[int]:
    """(16, nv) u32 16-bit-limb array -> plain int list (host paths)."""
    a = np.asarray(z_limbs, dtype=np.uint64)
    out = []
    for col in a.T:
        v = 0
        for k in range(15, -1, -1):
            v = (v << 16) | int(col[k])
        out.append(v)
    return out


def _on_device(engine, r1cs: R1CS, params) -> bool:
    """Whether the constraint check and the proof take the engine's
    device path: tiny circuits take prove()'s exact-host path, which
    consumes int lists."""
    return (
        engine is not None
        and hasattr(engine, "r1cs_satisfied")
        and hasattr(engine, "witness_limbs_dev")
        and max(r1cs.num_vars, params.domain_size - 1) >= STAGED_MIN
    )


def _prove_and_verify(r1cs, z, public_inputs, params, engine,
                      deterministic_rs, t) -> str:
    start = time.monotonic()
    r, s = deterministic_rs if deterministic_rs is not None else (None, None)
    proof = groth16_prove(params, r1cs, z, r=r, s=s, engine=engine)
    t["prove_s"] = time.monotonic() - start
    log.info(
        "Proof generation time: %.3fs (%d constraints, %.0f "
        "constraints/s)", t["prove_s"], r1cs.num_constraints,
        r1cs.num_constraints / t["prove_s"] if t["prove_s"] > 0 else 0.0,
    )

    start = time.monotonic()
    if not verify_proof(params.vk, proof, [v.v for _, v in public_inputs]):
        raise RuntimeError("proof self-verification failed")
    t["self_verify_s"] = time.monotonic() - start
    log.info("Proof verification time: %.3fs", t["self_verify_s"])
    return fmt.proof_to_json(proof, public_inputs)


def generate_verified_proof_z(
    r1cs: R1CS,
    z_limbs,
    z_head: list[int],
    params,
    engine=None,
    deterministic_rs: Optional[tuple[int, int]] = None,
    timings: Optional[dict] = None,
) -> str:
    """generate_verified_proof from a replayed R1CS assignment: z as
    the (16, nv) limb array, handed to the device engine as it is
    (witness_limbs_dev uploads it once); host paths get a plain int
    list."""
    t = timings if timings is not None else {}
    start = time.monotonic()
    device = _on_device(engine, r1cs, params)
    z = z_limbs if device else _z_ints(z_limbs)
    ok = engine.r1cs_satisfied(r1cs, z) if device else r1cs.is_satisfied(z)
    if not ok:
        raise WitnessRejected("constraints not satisfied by witness")
    t["sat_check_s"] = time.monotonic() - start
    log.info("Constraint check time: %.3fs for %d constraint (%s)",
             t["sat_check_s"], r1cs.num_constraints,
             "device" if device else "host")

    public_inputs = [(n, FS(v)) for n, v in zip(r1cs.input_names,
                                                 z_head[1:])]
    return _prove_and_verify(r1cs, z, public_inputs, params, engine,
                             deterministic_rs, t)


def generate_verified_proof(
    signals: Signals,
    ignore_signals: list[int],
    constraints: Constraints,
    params,
    engine=None,
    deterministic_rs: Optional[tuple[int, int]] = None,
    timings: Optional[dict] = None,
) -> str:
    """Constraint check -> proof -> self-verify -> proof.json
    (prover.rs:139-208)."""
    t = timings if timings is not None else {}
    start = time.monotonic()
    r1cs = R1CS.from_constraints(signals, constraints, ignore_signals)
    z = r1cs.assignment_from_signals(signals)
    device = _on_device(engine, r1cs, params)
    if device:
        if not engine.r1cs_satisfied(r1cs, z):  # device sparse matvec
            raise WitnessRejected("constraints not satisfied by witness")
    else:
        constraints.satisfies_with_signals(signals)
    t["sat_check_s"] = time.monotonic() - start
    log.info("Constraint check time: %.3fs for %d constraint (%s)",
             t["sat_check_s"], len(constraints),
             "device" if device else "host")

    public_inputs = []
    for n in range(len(signals)):
        signal = signals.get_by_id(n)
        if signal.is_main_public_input():
            public_inputs.append((signal.full_name, signal.value.v))
    return _prove_and_verify(r1cs, z, public_inputs, params, engine,
                             deterministic_rs, t)


def verify(json_verifying_key: str, proof_and_public_input: str) -> bool:
    """Verify proof.json against verifier.json (helper.rs:149-159)."""
    vk, _ = fmt.vk_from_json(json_verifying_key)
    proof, public_inputs = fmt.proof_from_json(proof_and_public_input)
    return verify_proof(vk, proof, public_inputs)
