"""The port's ``za`` CLI and helper on the CPU against za_tpu's.

The CLI round trip (setup -> prove -> verify) on example/ with
``--engine host``; ``setup`` and ``prove`` with their default engine,
the card, exit with an error where there is none and write nothing; ``compile`` and ``test`` print what
za_tpu's CLI prints.  helper.prove on each route against za_tpu's
proof.json string is tests/test_torch_gpucache.py's."""

import os
import shutil

import pytest
import torch

from za_tpu import cli as zcli
from za_tpu.groth16 import helper as zhelper
from za_tpu_torch import cli
from za_tpu_torch.groth16 import format as fmt
from za_tpu_torch.groth16 import helper

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def example(tmp_path, monkeypatch):
    for name in ("circuit.za", "input.json"):
        shutil.copy(os.path.join(ROOT, "example", name), tmp_path)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_cli_round_trip_on_the_host(example, capsys):
    assert cli.main(["setup", "--verifiertype", "json", "--engine",
                     "host"]) == 0
    assert cli.main(["prove", "--engine", "host"]) == 0
    assert sorted(os.listdir(example)) == [
        "circuit.za", "input.json", "proof.json", "proving.key",
        "proving.key.wtrace", "verifier.json"]
    capsys.readouterr()
    assert cli.main(["verify"]) == 0
    assert capsys.readouterr().out == "OK\n"
    vk, proof = ((example / f).read_text()
                 for f in ("verifier.json", "proof.json"))
    assert zhelper.verify(vk, proof)   # za_tpu accepts the port's proof

    # a second prove replays the trace; za_tpu proves from the port's pk
    assert cli.main(["prove", "--engine", "host", "--proof", "p2.json"]) == 0
    assert zcli.main(["prove", "--proof", "p3.json"]) == 0
    for name in ("p2.json", "p3.json"):
        assert helper.verify(vk, (example / name).read_text())

    tampered = proof.replace('"public_inputs":["6"]',
                             '"public_inputs":["7"]')
    assert tampered != proof
    (example / "proof.json").write_text(tampered)
    capsys.readouterr()
    assert cli.main(["verify"]) == 1
    assert capsys.readouterr().out == "INVALID\n"


def test_cli_prove_on_the_card_needs_one(example, capsys, monkeypatch):
    """The default engine is the card: without one, prove exits with an
    error and writes no proof; it does not prove on the host."""
    assert cli.main(["setup", "--verifiertype", "json", "--engine",
                     "host"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    for argv in (["prove"], ["prove", "--engine", "gpu"]):
        assert cli.main(argv) == 1
        err = capsys.readouterr().err
        assert err.startswith("error:") and "CUDA" in err
        assert not (example / "proof.json").exists()
    with pytest.raises(SystemExit):
        cli.main(["prove", "--engine", "tpu"])
    with pytest.raises(SystemExit):
        cli.main(["setup", "--engine", "tpu"])


def test_cli_setup_on_the_card_needs_one(example, capsys, monkeypatch):
    """setup's default engine is the card too: without one it exits with
    the CUDA error before compiling and leaves no proving key and no
    verifier; it does not set up on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["setup"], ["setup", "--engine", "gpu", "--verifiertype",
                             "json"]):
        assert cli.main(argv) == 1
        err = capsys.readouterr().err
        assert err.startswith("error:") and "CUDA" in err
        assert sorted(os.listdir(example)) == ["circuit.za", "input.json"]


@pytest.mark.parametrize("error", ["device_fault", "witness_rejected"])
def test_replay_retries_only_a_rejected_witness(example, monkeypatch, caplog,
                                                error):
    """After a replay only a witness that fails the constraint check is
    re-interpreted; any other error of the prove (the device's, the
    self-verification's) is raised as it is."""
    assert cli.main(["setup", "--verifiertype", "json", "--engine",
                     "host"]) == 0
    assert cli.main(["prove", "--engine", "host"]) == 0   # writes the trace
    calls = []

    def failing(*args, **kwargs):
        calls.append(error)
        if error == "device_fault":
            raise RuntimeError("device fault")
        raise helper.WitnessRejected("constraints not satisfied by witness")

    monkeypatch.setattr(helper, "generate_verified_proof_z", failing)
    inputs = fmt.flatten_json("main", (example / "input.json").read_text())
    if error == "device_fault":
        with pytest.raises(RuntimeError, match="device fault"):
            helper.prove("proving.key", inputs)
        assert "re-interpreting" not in caplog.text
    else:
        proof = helper.prove("proving.key", inputs)
        assert helper.verify((example / "verifier.json").read_text(), proof)
        assert "replayed witness rejected" in caplog.text
    assert calls == [error]


@pytest.mark.parametrize("argv", [["compile", "--print"], ["test"],
                                  ["test", "--prefix", "test_in"]])
def test_cli_prints_what_the_reference_prints(argv, tmp_path, monkeypatch,
                                              capsys):
    import test_torch_frontend as FE

    (tmp_path / "circuit.za").write_text(FE.SUBTEMPLATE)
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, main in (("ref", zcli.main), ("port", cli.main)):
        rc = main(argv)
        out[name] = (rc, capsys.readouterr().out)
    assert out["port"] == out["ref"]
    assert out["port"][0] == 0 and out["port"][1]
