"""The port's language bindings (za_tpu_torch/bindings/) on the CPU,
held against za_tpu's helper.

The C ABI, libza2c, is built with make into the test's directory and
its round trip (test_za2c.c) runs with engine("host"): setup -> prove ->
verify, a tampered proof rc 2, a proof buffer too small rc 1, a bad
verifier type and engine("tpu") rc 100; where torch sees no card the
default engine gives rc 100 with the CUDA error and writes nothing.
The Python binding runs its surface on the host, refuses the same way
without a card, and proves the 30-constraint chain (tests/
torch_chain_pk.py, the staged gate lowered to its size) through
GpuEngine(device="cpu") on its default engine.  Each binding's proof
and verifier verify under both helpers, za_tpu's and the port's, and a
tampered proof is rejected by both.  The Flutter and JS shims are
compile probes (no node toolchain here); Go runs `go vet` where there
is a go toolchain."""

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from za_tpu.groth16 import helper as zhelper
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16 import helper

import torch_chain_pk as CHAIN
from test_torch_prove import _one_thread  # noqa: F401 -- autouse fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIND = os.path.join(REPO, "za_tpu_torch", "bindings")
FACTOR_INPUT = '{"p":"2","q":"3","r":"6"}'
CIRCUIT = ("template Factor() {\n  signal private input p;\n"
           "  signal private input q;\n  signal input r;\n"
           "  p * q === r;\n}\ncomponent main = Factor();\n")
needs_cxx = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("make") is None,
    reason="C toolchain not available")
prove_mod = importlib.import_module("za_tpu_torch.groth16.prove")


def _tampered(proof_json: str) -> str:
    doc = json.loads(proof_json)
    doc["public_inputs"][0] = str(int(doc["public_inputs"][0]) + 1)
    return json.dumps(doc)


def _held_against_both_helpers(vk_json: str, proof_json: str) -> None:
    assert zhelper.verify(vk_json, proof_json)
    assert helper.verify(vk_json, proof_json)
    bad = _tampered(proof_json)
    assert not zhelper.verify(vk_json, bad)
    assert not helper.verify(vk_json, bad)


def _env(**extra) -> dict:
    """The embedded interpreter's path: this checkout and this one's."""
    path = [REPO] + [p for p in sys.path if p]
    return {**os.environ, "PYTHONPATH": os.pathsep.join(path), **extra}


@pytest.fixture(scope="module")
def za2c(tmp_path_factory):
    """libza2c and test_za2c built with the port's Makefile -> the
    build directory."""
    build = tmp_path_factory.mktemp("za2c")
    proc = subprocess.run(
        ["make", "-C", os.path.join(BIND, "c"), f"BUILD={build}",
         str(build / "test_za2c")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return build


def _run_test_za2c(build, work, *args, **env):
    return subprocess.run([str(build / "test_za2c"), str(work), *args],
                          capture_output=True, text=True, timeout=300,
                          env=_env(ZA_TPU_ROOT=REPO, **env))


@needs_cxx
def test_c_binding_round_trip_on_the_host(za2c, tmp_path):
    proc = _run_test_za2c(za2c, tmp_path, "host")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout.splitlines()
    assert out[-1] == "ALL C BINDING TESTS PASS"
    assert "tampered proof rejected ok" in out and "engines []" in out
    assert [line.split()[1] for line in out if line.startswith("za2c ")] \
        == ["setup", "prove", "verify"]
    assert "Setup time" in proc.stderr and "(host)" in proc.stderr
    _held_against_both_helpers((tmp_path / "verifier.json").read_text(),
                               (tmp_path / "proof.json").read_text())
    assert not (tmp_path / "bad.key").exists()


@needs_cxx
def test_c_binding_default_engine_needs_a_card(za2c, tmp_path):
    """Where torch sees no card, setup and prove on the default engine
    give rc 100 with the CUDA error and write nothing (test_za2c's
    nocard mode); engine("host") then sets up."""
    proc = _run_test_za2c(za2c, tmp_path, "nocard", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "NO CARD REFUSED OK"
    assert sorted(os.listdir(tmp_path)) == ["circuit.za", "proving.key"]


@pytest.fixture
def za2py():
    """The port's Python binding, loaded from its file under a name of
    its own (the reference's module is za2py too)."""
    spec = importlib.util.spec_from_file_location(
        "za2py_torch", os.path.join(BIND, "python3", "za2py.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_python_binding_surface_on_the_host(za2py, tmp_path, monkeypatch):
    for fn in ("setup", "prove", "verify", "verbose"):
        assert callable(getattr(za2py, fn))
    circuit = tmp_path / "circuit.za"
    circuit.write_text(CIRCUIT)
    pk = str(tmp_path / "proving.key")
    monkeypatch.chdir(tmp_path)

    # the default engine is the card: without one, the CUDA error and
    # nothing written
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: za2py.setup(str(circuit), pk, "json"),
                 lambda: za2py.prove(pk, FACTOR_INPUT)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        assert sorted(os.listdir(tmp_path)) == ["circuit.za"]
    with pytest.raises(ValueError, match="engine"):
        za2py.setup(str(circuit), pk, "json", engine="tpu")

    level = helper.log.level
    try:
        za2py.verbose(True)
        assert helper.log.getEffectiveLevel() == 20
        za2py.verbose(False)
        assert helper.log.getEffectiveLevel() == 30
    finally:
        helper.log.setLevel(level)
    vk = za2py.setup(str(circuit), pk, "json", engine="host")
    proof = za2py.prove(pk, FACTOR_INPUT, engine="host")
    assert za2py.verify(vk, proof) and not za2py.verify(vk, _tampered(proof))
    _held_against_both_helpers(vk, proof)


def test_python_binding_proves_through_the_engine(za2py, tmp_path,
                                                  monkeypatch):
    """The default engine, a GpuEngine (on the CPU here), proves the
    chain's pk on its dense route."""
    for mod in (prove_mod, helper):
        monkeypatch.setattr(mod, "STAGED_MIN", CHAIN.STAGED_GATE)
    monkeypatch.setattr("za_tpu_torch.engine.msm_dense.CPU_SLOTS",
                        {False: 16, True: 16})
    chain = CHAIN.build(str(tmp_path / "chain"))
    eng = GpuEngine(device="cpu")
    monkeypatch.setattr(za2py, "_gpu", eng)
    pk = os.path.join(chain["dir"], "proving.key")
    proof = za2py.prove(pk, json.dumps({"x": str(CHAIN.INPUT_X)}))
    assert (eng.stage_info["source"], eng.stage_info["cache"]) == (
        "staged", None)                         # dense: no table cache
    assert json.loads(proof)["public_inputs"] == \
        json.loads(chain["proof_json"])["public_inputs"]
    _held_against_both_helpers(chain["vk_json"], proof)


@needs_cxx
def test_flutter_binding_builds(za2c):
    proc = subprocess.run(
        ["make", "-C", os.path.join(BIND, "flutter"), f"BUILD={za2c}"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (za2c / "libza2flutter.so").exists()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_js_binding_compile_probe():
    """No node toolchain here: the N-API addon, engine() included,
    compiled against the vendored declaration stub."""
    src = os.path.join(BIND, "js", "za2node.cc")
    assert '"engine"' in open(src).read()
    proc = subprocess.run(
        ["g++", "-fsyntax-only", "-std=c++17",
         "-I", os.path.join(BIND, "js", "ci_stub"), src],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.skipif(shutil.which("go") is None, reason="no go toolchain")
def test_go_binding_vets(za2c):
    """go vet over libza2c, built where lib.go's cgo flags look."""
    subprocess.run(["make", "-C", os.path.join(BIND, "c")], check=True,
                   timeout=300)
    proc = subprocess.run(["go", "vet", "."], cwd=os.path.join(BIND, "go"),
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "GO111MODULE": "off"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
