#!/usr/bin/env python3
"""Run one cell of the prover's benchmark once.

    python3 prover_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port ``za_tpu_torch``, on a machine with the cards the cell
asks for.  A cell (BENCHMARK.json ``workloads``) names a configuration
(its JSON file: ``generator``, the circuit's sizes) and a traffic mix
(``prover_bench/traffic/<name>.json``: its ``loop``, found as
``prover_bench/loops/<loop>.py``, and the witness pool).  Set-up builds the circuit
(``prover_bench/circuits/<generator>.py``), a pool of witnesses and a
proving key from the seed, builds or loads the kernels, stages the key
(``GpuEngine.stage_params``) and proves once; the window then proves
for ``--seconds`` in the traffic's loop, each proof from a new
witness list and its own r and s, through
``za_tpu_torch.groth16.prove.prove``.  After the window every proof's
A, B and C is held against the plain reference
(``prover_bench/reference``).

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones: the engine's stage lines on (``ZA_METRICS=1``), and a
stretch of the window under ``torch.profiler``.  Each metric's value
comes from ``prover_bench/metrics/<metric>.py``.  The last line of
standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last
key.  Without the cards the cell asks for it exits 2 and prints no
result; it exits 3 and prints none if the process has loaded jax,
jaxlib, flax or za_tpu.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from contextlib import ExitStack, nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

#: top-level module names the process may not hold after the window
FORBIDDEN = ("jax", "jaxlib", "flax", "za_tpu")
#: longest stretch of a traced window under the profiler, seconds
TRACE_SECONDS = 8.0


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"prover_bench_{path.parent.name}_{path.stem}".replace("-", "_"),
        path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json with everything found by its names."""

    def __init__(self, root: Path, name: str):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        self.root = root
        self.bench = bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
        self.cell = cells[name]
        self.name = name
        entry = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic = json.loads(
            (root / "prover_bench" / "traffic"
             / f"{self.cell['traffic']}.json").read_text())
        self.generator = load_module(
            root / "prover_bench" / "circuits"
            / f"{self.config['generator']}.py")
        self.loop = load_module(
            root / "prover_bench" / "loops" / f"{self.traffic['loop']}.py")
        self.peaks = json.loads(
            (root / "prover_bench" / "peaks.json").read_text())

    def metrics(self, kind: str) -> list:
        """The cell's metrics of ``kind`` ("end_to_end", "per_layer")."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(self.root / "prover_bench" / "metrics"
                           / f"{metric}.py")

    def work(self, layer: str):
        return load_module(self.root / "prover_bench" / "work"
                           / f"{layer}.py")


def card_check(chips: int) -> str:
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        log(f"{found} CUDA devices, the cell asks for {chips}: this "
            f"benchmark runs on the card and nowhere else")
        raise SystemExit(2)
    return torch.cuda.get_device_name(0)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


class GcLog:
    """The interpreter's garbage collections inside a block: count and
    seconds by generation."""

    def __enter__(self):
        self.runs: dict = {}
        self._t = None
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            n, s = self.runs.get(info["generation"], (0, 0.0))
            self.runs[info["generation"]] = (
                n + 1, s + time.perf_counter() - self._t)

    def summary(self) -> dict:
        return {f"gen{g}": [n, round(s, 4)]
                for g, (n, s) in sorted(self.runs.items())}


class Window:
    """The window's requests: ``serve(i)`` proves request i from witness
    i mod W, a new list, and the next r and s; in a traced run it takes
    the stage lines of each proof and puts a stretch of up to
    TRACE_SECONDS, from the middle of the window on, under the
    profiler (started and stopped outside any proof's timing)."""

    def __init__(self, program, state, witnesses, rs, args):
        self.program, self.state = program, state
        self.witnesses, self.rs, self.args = witnesses, rs, args
        self.lines = None
        self.out: list = []
        self.failures: list = []
        self.trace = None
        self._stack = self._box = self._t0 = None
        self._start = time.perf_counter()

    def _trace_now(self) -> bool:
        if not self.args.trace or self.trace is not None:
            return False
        now = time.perf_counter()
        if self._box is None:
            if now - self._start >= self.args.seconds / 2:
                from prover_bench.trace import traced

                self._stack = ExitStack()
                self._box = self._stack.enter_context(
                    traced(self.state[2].device.type))
                self._t0 = time.perf_counter()
        elif now - self._t0 >= TRACE_SECONDS:
            self.stop_trace()
        return self._box is not None and self.trace is None

    def stop_trace(self) -> None:
        if self._box is not None and self.trace is None:
            self._stack.close()
            self.trace = self._box["trace"]

    def serve(self, i: int) -> None:
        from torch.profiler import record_function

        span = (record_function("bench.prove") if self.args.trace
                else nullcontext())
        in_stretch = self._trace_now()
        k = i % len(self.witnesses)
        z = list(self.witnesses[k])
        r, s = self.rs.next()
        n0 = len(self.lines) if self.lines is not None else 0
        prm, rc, eng = self.state
        t = time.perf_counter()
        try:
            with span:
                proof = self.program.prove_once(prm, rc, z, r, s, eng)
        except Exception:
            self.failures.append(traceback.format_exc())
            proof = None
        wall = time.perf_counter() - t
        self.out.append({
            "witness": k, "r": r, "s": s, "proof": proof, "wall": wall,
            "stretch": in_stretch,
            "lines": (self.lines[n0:] if self.lines is not None
                      else None)})


def run(argv=None, root: Path = HERE.parent, device=None):
    """One run -> (result, checks).  ``device`` None: the card, which
    must be there; the tests pass "cpu" to drive the rest of a run."""
    args = parse(argv)
    cell = Cell(root, args.workload)
    kind = None
    if device is None:
        kind = card_check(cell.cell["chips"])
        device = "cuda"
    if args.trace:
        os.environ["ZA_METRICS"] = "1"

    from prover_bench import inputs, program
    from prover_bench.reference.groth16 import Expected, judge

    import torch

    cuda = device == "cuda"
    setup = {"imports_s": time.monotonic() - T_START}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg, traffic, seed = cell.config, cell.traffic, args.seed

    t = time.monotonic()
    gc.disable()    # millions of rows: no collection passes while built
    try:
        circuit = cell.generator.rows(cfg)
        W = inputs.pool_size(traffic, len(circuit["a"]))
        witnesses = inputs.witness_pool(cell.generator, cfg, seed, W)
        logs = inputs.proving_key_logs(seed)
        pk = inputs.proving_key(circuit, logs)
    finally:
        gc.enable()
    setup["inputs_s"] = time.monotonic() - t

    t = time.monotonic()
    if cuda:
        program.build_kernels()
    setup["build_s"] = time.monotonic() - t
    t = time.monotonic()
    rc = program.r1cs(circuit)
    prm = program.params(pk)
    del pk
    eng = program.GpuEngine(device=device)
    setup["program_s"] = time.monotonic() - t
    t = time.monotonic()
    eng.stage_params(prm, rc)
    setup["stage_s"] = time.monotonic() - t
    warm = inputs.stream(seed, "warmup")
    for i in range(traffic["warmup_proofs"]):
        t = time.monotonic()
        program.prove_once(prm, rc, list(witnesses[i % W]),
                           warm.randrange(1, inputs.R),
                           warm.randrange(1, inputs.R), eng)
        if i == 0:
            setup["first_prove_s"] = time.monotonic() - t
    setup["setup_s"] = time.monotonic() - T_START
    log("setup " + json.dumps(setup))

    win = Window(program, (prm, rc, eng), witnesses,
                 inputs.Randomness(seed), args)
    gcs = GcLog()
    with ExitStack() as stack:
        stack.enter_context(gcs)
        if args.trace:
            win.lines = stack.enter_context(program.StageLines()).lines
        t0, recs = cell.loop.drive(traffic, args.seconds, win.serve)
        win.stop_trace()
    out, failures = win.out, win.failures

    memory_peak = program.memory_peak_bytes(device)
    del eng, prm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    done = [i for i, o in enumerate(out) if o["proof"] is not None]
    window = {"seconds": (recs[-1][2] - t0) if recs else 0.0,
              "records": [recs[i] for i in done]}
    if failures:
        log(f"{len(failures)} proofs failed; the first:\n{failures[0]}")
    log(f"window: garbage collections {gcs.summary()}")
    walls = [o["wall"] for o in out]
    if walls:
        log(f"window: {len(walls)} proofs in {window['seconds']:.3f}s, "
            f"the first {[round(w, 4) for w in walls[:3]]}, median "
            f"{sorted(walls)[len(walls) // 2]:.4f}s, max {max(walls):.4f}s")

    t = time.monotonic()
    expected = Expected(circuit, logs)
    wrong = judge(expected, witnesses,
                  [(o["witness"], o["r"], o["s"], program.plain(o["proof"]))
                   for o in (out[i] for i in done)])
    log(f"reference: {len(done)} proofs checked in "
        f"{time.monotonic() - t:.3f}s")
    checks = {f"wrong_{k}": [v, 0] for k, v in wrong.items()}
    checks["failed"] = [len(failures), 0]
    correct = all(v <= lim for v, lim in checks.values())

    trace = win.trace
    ctx = {"setup": setup, "window": window,
           "proofs": [out[i] for i in done], "trace": trace,
           "stretch": [out[i]["witness"] for i in done
                       if out[i]["stretch"]], "circuit": circuit,
           "witnesses": witnesses, "peaks": cell.peaks,
           "memory_peak_bytes": memory_peak, "work": cell.work}
    metrics = {}
    for m in cell.metrics("per_layer" if args.trace else "end_to_end"):
        v = cell.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": kind or str(device),
           "count": cell.cell["chips"] if cuda else 0,
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(out),
              "failed": len(failures), "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.top_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    if cuda:
        log(f"card: {card_line()}; peaks {json.dumps(cell.peaks)}")
    forbidden = forbidden_modules()
    if forbidden:
        log(f"the process holds forbidden modules: {forbidden}")
        raise SystemExit(3)
    return result, checks


def main(argv=None) -> int:
    result, checks = run(argv)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
