"""The harness at a tiny size on the CPU: BENCHMARK.json against the
contract's shape, everything found by name, a throwaway configuration
added with new files and entries only, a run with no card, the import
guard, the traffic loop, the idle share's reader, and runs with the timed path broken
underneath, each of which must read not correct."""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from prover_bench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
TINY = 30          # constraints of the throwaway chain


def test_benchmark_json_has_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["prover_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"] + BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower",
                                                             "higher")
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", cells):
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert w in moved.get("workloads", cells)
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"].startswith("prover_bench/")


def test_everything_is_found_by_name():
    cells = {w["name"] for w in BENCH["workloads"]}
    for name in cells:
        cell = run.Cell(ROOT, name)
        assert cell.config["name"] == cell.cell["config"]
        assert callable(cell.generator.rows)
        assert callable(cell.loop.drive)
        for kind in ("end_to_end", "per_layer"):
            for m in cell.metrics(kind):
                assert callable(cell.reader(m["name"]).read)
    for layer in ("h", "msm"):
        assert run.Cell(ROOT, sorted(cells)[0]).work(layer).KERNELS


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "prover_bench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "3000000001",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_import_guard_compares_top_level_names_whole(monkeypatch):
    for name in ("za_tpu_torch", "za_tpu_torch.engine", "jaxtyping",
                 "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, sys.modules["json"])
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "za_tpu.curve", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["json"])
    assert run.forbidden_modules() == ["jax", "za_tpu"]


def test_the_run_loads_no_jax_and_no_za_tpu():
    code = ("import sys; from prover_bench import run, program, inputs, "
            "trace; from prover_bench.reference import groth16; "
            "import za_tpu_torch.engine.engine; "
            "print(run.forbidden_modules(), "
            "'za_tpu_torch.groth16.prove' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[] True"


def test_traffic_generators():
    """The closed loop, found by the traffic file's ``loop``: one request
    at a time, in order, until the window's seconds have passed."""
    cell = run.Cell(ROOT, BENCH["workloads"][0]["name"])
    served = []
    t0, recs = cell.loop.drive(cell.traffic, 0.05, served.append)
    assert recs and [r[0] for r in recs] == served == list(range(len(recs)))
    assert all(t0 <= a <= b for _, a, b in recs)
    assert all(recs[i][2] <= recs[i + 1][1] for i in range(len(recs) - 1))


def test_device_idle_share_counts_no_profiler_time():
    """Busy seconds a proof of the profiled stretch over the median wall
    of the traced proofs outside it: a stretch slowed by the profiler
    does not raise the idle share."""
    from prover_bench.trace import Trace

    reader = run.Cell(ROOT, BENCH["workloads"][0]["name"]).reader(
        "device_idle_pct")
    # 4 proofs in a 10 s stretch, the card busy 0.5 s of each
    dev = [("k", 2.0 * i + 0.1, 2.0 * i + 0.6) for i in range(4)]
    tr = Trace(0.0, 10.0, dev, [])
    proofs = [{"wall": w, "lines": [("h.matvec", 0.1, 0.1)],
               "stretch": False} for w in (1.9, 2.0, 2.1)]
    proofs += [{"wall": 2.5, "lines": [("h.matvec", 0.1, 0.1)],
                "stretch": True}] * 4
    ctx = {"trace": tr, "stretch": [0, 1, 2, 3], "proofs": proofs}
    assert reader.read(ctx) == pytest.approx(75.0)
    assert reader.read(dict(ctx, trace=Trace(0.0, 10.0, [], []))) is None
    assert reader.read(dict(ctx, stretch=[])) is None


# -- whole runs on the CPU, on a throwaway configuration ----------------------


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout's copy with one more configuration, traffic mix, cell
    and per-layer metric, added as new files and new BENCHMARK.json
    entries only; the prover's staged gate lowered to the chain's size
    so that the engine's route runs at 32 points."""
    shutil.copytree(ROOT / "prover_bench", tmp_path / "prover_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "prover_bench"
    cfg = json.loads((pb / "configs" / "chain-128k.json").read_text())
    cfg.update(name="chain-tiny", constraints=TINY)
    (pb / "configs" / "chain-tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "closed-once.json").write_text(json.dumps({
        "loop": "closed", "warmup_proofs": 1,
        "witness_pool": {"constraints": 4 * TINY, "min": 2, "max": 3}}))
    (pb / "metrics" / "proofs_made.py").write_text(
        "def read(ctx):\n    return len(ctx['window']['records'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "chain-tiny", "source": "https://github.com/adria0/za",
        "file": "prover_bench/configs/chain-tiny.json",
        "reduced": ["constraints"], "why": "a test"})
    bench["workloads"].append({
        "name": "chain-tiny.closed-once", "config": "chain-tiny",
        "traffic": "closed-once", "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        m["workloads"].append("chain-tiny.closed-once")
    bench["end_to_end"].append({
        "name": "proofs_made", "unit": "proofs", "better": "higher",
        "bound": 0.01, "source": "host_clock",
        "workloads": ["chain-tiny.closed-once"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(
        importlib.import_module("za_tpu_torch.groth16.prove"), "STAGED_MIN",
        TINY + 2)
    return tmp_path


def tiny_run(root, trace=0, seconds="0.05"):
    return run.run(["--workload", "chain-tiny.closed-once", "--seed",
                    "2147483659", "--seconds", seconds, "--trace",
                    str(trace)], root=root, device="cpu")


def test_a_new_config_traffic_cell_and_metric_need_only_new_files(
        tiny_root):
    result, checks = tiny_run(tiny_root)
    assert result["correct"] and checks["wrong_C"] == [0, 0]
    assert result["metrics"]["proofs_made"]["value"] >= 1
    assert set(result["metrics"]) == {"proofs_per_s", "setup_s",
                                      "proofs_made"}
    assert list(result)[-1] == "checks"


def test_a_traced_run_reads_the_stage_lines(tiny_root, monkeypatch):
    from za_tpu_torch.engine.metrics import StageTimer

    monkeypatch.setattr(StageTimer, "enabled", True)
    monkeypatch.setattr(run, "TRACE_SECONDS", 0.0)
    result, _ = tiny_run(tiny_root, trace=1, seconds="6")
    assert result["correct"]
    got = result["metrics"]
    assert {"stage_s", "first_prove_s", "prove_host_ms",
            "witness_upload_ms"} <= set(got)
    # on the CPU no device time: no device metric is read
    assert not {"h_device_ms", "msm_device_ms", "h_roofline_pct",
                "msm_roofline_pct", "device_idle_pct"} & set(got)
    assert result["device"]["platform"] == "cpu"


def _stale(orig):
    last = {}

    def prove_once(prm, rc, z, r, s, eng):
        if "p" not in last:
            last["p"] = orig(prm, rc, z, r, s, eng)
        return last["p"]
    return prove_once


def _altered(orig):
    from za_tpu_torch.curve import G1_GEN, g1_add

    def prove_once(*a):
        p = orig(*a)
        p.c = g1_add(p.c, G1_GEN)
        return p
    return prove_once


def _control(orig):
    """The reference, its witness values cut to 253 bits in the witness
    MSMs, in the prover's place."""
    from prover_bench import inputs
    from prover_bench.circuits import chain
    from prover_bench.reference.groth16 import Expected, control_proofs
    from za_tpu_torch.curve import Fq2
    from za_tpu_torch.groth16.prove import Proof

    cfg = {"constraints": TINY}
    exp = Expected(chain.rows(cfg), inputs.proving_key_logs(2147483659))

    def prove_once(prm, rc, z, r, s, eng):
        (_, _, _, (a, b, c)), = control_proofs(exp, [z], [(0, r, s)],
                                               (1 << 253) - 1)
        return Proof(a=a, b=(Fq2(*b[0]), Fq2(*b[1])), c=c)
    return prove_once


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "control"])
def test_a_broken_timed_path_reads_not_correct(tiny_root, monkeypatch,
                                               fault):
    """A step that returns its state unchanged (the warm-up's proof
    again), half of each MSM's scalars left out, an answer altered where it
    is made, and the control in the prover's place."""
    from prover_bench import program

    orig = program.prove_once
    if fault == "half":
        from za_tpu_torch.engine.engine import GpuEngine

        scalars = GpuEngine._scalars

        def half(self, tabs, scalars_list):
            sc = scalars(self, tabs, scalars_list).clone()
            sc[..., sc.shape[-1] // 2:] = 0
            return sc
        monkeypatch.setattr(GpuEngine, "_scalars", half)
    else:
        wrap = {"stale": _stale, "altered": _altered,
                "control": _control}[fault]
        monkeypatch.setattr(program, "prove_once", wrap(orig))
    result, checks = tiny_run(tiny_root)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert not result["correct"]
    assert sum(v for v, _ in checks.values()) > 0


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """The 2^17 cell for a few seconds on the card: correct, with its
    end-to-end metrics (card only)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run.run(["--workload", "chain-128k.closed", "--seed",
                         "2147483701", "--seconds", "3", "--trace", "0"])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert {"proofs_per_s", "setup_s"} <= set(result["metrics"])
