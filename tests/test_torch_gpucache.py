"""helper.prove from a proving key on each of the port's routes against
za_tpu's proof.json, and the port's staged-table cache, <pk>.gpucache,
on the CPU.

One directory holds the 30-constraint chain's pk (tests/torch_chain_pk.py)
and a reference-engine <pk>.devcache; every test lowers the staged gate
to the chain's size (torch_chain_pk.STAGED_GATE), so the engine routes
run at 32 points.  In it helper.prove runs, in
order: with the exact host engine (interpreting the circuit, writing
<pk>.wtrace), with GpuEngine(device="cpu") on the dense route
(replaying the trace), and on the tree route (TREE_MIN lowered, as
tests/test_torch_prove.py does) in a fresh engine after a staging wrote
<pk>.gpucache (replaying, loading the tables).  Each returns za_tpu's
proof.json string; <pk>.devcache is neither read nor touched.  With
ZA_WTRACE=0 and ZA_DEVCACHE=0 a tree-route prove writes neither file.
A changed pk (another digest), another layout or a corrupt file
restages."""

import importlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import za_tpu_torch.engine.engine as engine_mod
import za_tpu_torch.engine.msm_dense as msm_dense
from za_tpu_torch.compiler.wtrace import pk_digest
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16 import format as fmt
from za_tpu_torch.groth16 import helper

import torch_chain_pk as CHAIN
# the module (the package's name "prove" is its function)
prove_mod = importlib.import_module("za_tpu_torch.groth16.prove")
from test_torch_prove import _one_thread  # noqa: F401 -- autouse fixture

# the dense plain version's lane split on the CPU: any split gives the
# same MSM bit for bit (engine/msm_dense.py); a narrow one costs the CPU
# less than the H100's, which tests/test_torch_prove.py runs
NARROW_SLOTS = {False: 16, True: 16}


@pytest.fixture(autouse=True)
def _staged_gate(monkeypatch):
    """The staged branch from the chain's size on: helper.prove's
    constraint check and groth16.prove both read the gate."""
    for mod in (prove_mod, helper):
        monkeypatch.setattr(mod, "STAGED_MIN", CHAIN.STAGED_GATE)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    return CHAIN.build(str(tmp_path_factory.mktemp("chain")))


_WATCHED: list = []
_HOOKED: list = []


def _audit(event, args):
    if _WATCHED and any(".devcache" in str(a) for a in args):
        _WATCHED.append((event, args))


def _watch_devcache() -> None:
    """Record every audited file event naming a .devcache path while
    _WATCHED is non-empty (an audit hook stays for the process's life,
    so it is added once, by the fixture that needs it)."""
    if not _HOOKED:
        sys.addaudithook(_audit)
        _HOOKED.append(True)
    _WATCHED.append("on")


def _snapshot(d):
    return {p.name: (p.read_bytes(), p.stat().st_mtime_ns)
            for p in d.iterdir()}


@pytest.fixture(scope="module")
def seq(chain, tmp_path_factory):
    """The directory of the prove sequence: the chain's pk and a
    reference-engine cache beside it, which the port must leave be."""
    d = tmp_path_factory.mktemp("seq")
    shutil.copy(os.path.join(chain["dir"], "proving.key"), d)
    devcache = d / "proving.key.devcache"
    devcache.mkdir()
    (devcache / "meta.json").write_text('{"version": 1}')
    state = {"dir": d, "pk": str(d / "proving.key"), "chain": chain,
             "devcache": _snapshot(devcache), "runs": {}}
    _watch_devcache()
    yield state
    _WATCHED.clear()


def _stage_to_cache(pk: str):
    """Stage the pk's tables on the tree route with helper.prove's cache
    path and key: writes <pk>.gpucache -> the staging's stage_info."""
    from za_tpu_torch.compiler import Evaluator, Mode, optimize
    from za_tpu_torch.compiler.evaluator import Scope
    from za_tpu_torch.groth16.r1cs import R1CS

    ev = Evaluator(Mode.GEN_CONSTRAINTS)
    ev.eval_inline(Scope(True, None, "root"), CHAIN.CIRCUIT)
    cons, removed = optimize(ev.constraints, ev.signals.main_input_ids())
    with open(pk, "rb") as f:
        params = fmt.read_pk(f, raw_queries=True).params
    params._gpucache_path = pk + helper.GPUCACHE_SUFFIX
    params._gpucache_digest = pk_digest(pk).hex()
    eng = GpuEngine(device="cpu")
    eng.stage_params(params, R1CS.from_constraints(ev.signals, cons, removed))
    return dict(eng.stage_info)


ROUTES = ("host", "dense", "tree")


def _run(seq, route: str) -> dict:
    """helper.prove on the route in the sequence's directory, once,
    after the routes before it -> {"proof", "timings", "stage_info"}."""
    for before in ROUTES[:ROUTES.index(route)]:
        _run(seq, before)
    if route in seq["runs"]:
        return seq["runs"][route]
    run = {}
    with pytest.MonkeyPatch.context() as mp:
        eng = None
        if route == "dense":
            mp.setattr(msm_dense, "CPU_SLOTS", NARROW_SLOTS)
            eng = GpuEngine(device="cpu")
        elif route == "tree":
            mp.setattr(engine_mod, "TREE_MIN", 0)
            run["staging"] = _stage_to_cache(seq["pk"])
            eng = GpuEngine(device="cpu")
        t = {}
        run["proof"] = helper.prove(seq["pk"], CHAIN.port_inputs(),
                                    engine=eng, deterministic_rs=CHAIN.RS,
                                    timings=t)
    run["timings"] = t
    run["stage_info"] = dict(eng.stage_info) if eng is not None else None
    seq["runs"][route] = run
    return run


@pytest.mark.parametrize("route", ROUTES)
def test_helper_prove_matches_reference(seq, route):
    run = _run(seq, route)
    assert run["proof"] == seq["chain"]["proof_json"]
    assert helper.verify(seq["chain"]["vk_json"], run["proof"])
    t, info = run["timings"], run["stage_info"]
    cache = seq["pk"] + helper.GPUCACHE_SUFFIX
    if route == "host":
        # the first prove interprets and writes the trace za_tpu writes
        assert t["witness"] == "interpret"
        with open(seq["pk"] + ".wtrace", "rb") as f, open(os.path.join(
                seq["chain"]["ref_dir"], "proving.key.wtrace"), "rb") as g:
            assert f.read() == g.read()
        assert info is None and not os.path.exists(cache)
        return
    assert t["witness"] == "replay_native"
    if route == "dense":
        assert info == {"source": "staged", "cache": None,
                        "stage_s": info["stage_s"]}
        assert not os.path.exists(cache)
    else:
        assert (info["source"], info["cache"]) == ("cache", "hit")


def test_tree_route_writes_then_loads_the_cache(seq):
    """The staging writes <pk>.gpucache under helper.prove's key, the
    tree-route prove in a fresh engine loads it; the reference engine's
    <pk>.devcache is never opened or changed."""
    run = _run(seq, "tree")
    accessed = _WATCHED[1:]
    assert accessed == []
    assert _snapshot(seq["dir"] / "proving.key.devcache") == seq["devcache"]
    s1, s2 = run["staging"], run["stage_info"]
    assert (s1["source"], s1["cache"]) == ("staged", "miss")
    assert (s2["source"], s2["cache"]) == ("cache", "hit")
    assert s1["cache_bytes"] == s2["cache_bytes"] > 0
    pk = seq["pk"]
    meta = json.loads((seq["dir"] / "proving.key.gpucache" /
                       "meta.json").read_text())
    assert meta["engine"] == "gpu"
    assert meta["digest"] == pk_digest(pk).hex()
    assert meta["tree_min"] == 0 and meta["msm_style"] is None
    assert meta["version"] == engine_mod.GPUCACHE_VERSION
    assert {k: (v["chunk_cols"], v["chunks"])
            for k, v in meta["tables"].items()} == {
        "g1abl": (32, 1), "g1h": (32, 1), "b_g2x": (32, 1)}
    assert sorted(os.listdir(seq["dir"])) == [
        "proving.key", "proving.key.devcache", "proving.key.gpucache",
        "proving.key.wtrace"]


def test_switches_off_write_no_files(chain, tmp_path, monkeypatch):
    """ZA_WTRACE=0 and ZA_DEVCACHE=0, the reference's switches: a
    tree-route prove interprets, stages without a cache and leaves
    nothing beside the pk."""
    monkeypatch.setenv("ZA_WTRACE", "0")
    monkeypatch.setenv("ZA_DEVCACHE", "0")
    monkeypatch.setattr(engine_mod, "TREE_MIN", 0)
    shutil.copy(os.path.join(chain["dir"], "proving.key"), tmp_path)
    eng = GpuEngine(device="cpu")
    t = {}
    got = helper.prove(str(tmp_path / "proving.key"), CHAIN.port_inputs(),
                       engine=eng, deterministic_rs=CHAIN.RS, timings=t)
    assert got == chain["proof_json"]
    assert t["witness"] == "interpret"
    assert (eng.stage_info["source"], eng.stage_info["cache"]) == (
        "staged", None)
    assert os.listdir(tmp_path) == ["proving.key"]


_SMALL: dict = {}


def _stage(path, digest):
    """Stage the chain at N = 16 (its pk written once, read raw) with the
    cache at path under digest -> (tables, stage_info)."""
    if not _SMALL:
        from test_torch_frontend import CHAIN as TEXT
        from za_tpu_torch.compiler import Evaluator, Mode, optimize
        from za_tpu_torch.compiler.evaluator import Scope
        from za_tpu_torch.groth16.r1cs import R1CS
        from za_tpu_torch.groth16.setup import generate_parameters

        ev = Evaluator(Mode.GEN_CONSTRAINTS)
        ev.eval_inline(Scope(True, None, "root"), TEXT % 16)
        cons, removed = optimize(ev.constraints, ev.signals.main_input_ids())
        r1cs = R1CS.from_constraints(ev.signals, cons, removed)
        buf = io.BytesIO()
        fmt.write_pk(buf, ev.collected_asts, cons, removed,
                     generate_parameters(r1cs, **CHAIN.TOXIC),
                     densities=r1cs.densities())
        _SMALL.update(data=buf.getvalue(), r1cs=r1cs)
    params = fmt.read_pk(io.BytesIO(_SMALL["data"]), raw_queries=True).params
    params._gpucache_path = str(path)
    params._gpucache_digest = digest
    eng = GpuEngine(device="cpu")
    return eng.stage_params(params, _SMALL["r1cs"]), dict(eng.stage_info)


def _same(a, b):
    return all(torch.equal(getattr(a[k], f), getattr(b[k], f))
               for k in engine_mod.TREE_TABLES for f in ("tx", "ty", "ident"))


def test_changed_pk_restages(tmp_path, monkeypatch):
    monkeypatch.setattr(engine_mod, "TREE_MIN", 0)
    path = tmp_path / "proving.key.gpucache"
    first, info = _stage(path, "aa")
    assert info["cache"] == "miss"
    again, info = _stage(path, "aa")
    assert info["cache"] == "hit" and _same(first, again)
    # a new pk digest: restaged, and the cache now carries the new key
    other, info = _stage(path, "bb")
    assert (info["source"], info["cache"]) == ("staged", "stale")
    assert json.loads((path / "meta.json").read_text())["digest"] == "bb"
    assert _same(first, other)
    assert _stage(path, "bb")[1]["cache"] == "hit"
    # another layout (TREE_MIN is in the key), then a corrupt table file
    monkeypatch.setattr(engine_mod, "TREE_MIN", 8)
    assert _stage(path, "bb")[1]["cache"] == "stale"
    assert _stage(path, "bb")[1]["cache"] == "hit"
    np.save(path / "g1h_tx.npy", np.zeros((1, 2), np.int32))
    tabs, info = _stage(path, "bb")
    assert info["cache"] == "stale" and _same(first, tabs)
    assert _stage(path, "bb")[1]["cache"] == "hit"
    assert sorted(os.listdir(tmp_path)) == ["proving.key.gpucache"]


def test_dense_route_and_no_path_leave_no_cache(tmp_path):
    """Below TREE_MIN the tables are the dense kernel's: no cache."""
    path = tmp_path / "proving.key.gpucache"
    tabs, info = _stage(path, "aa")
    assert "g1x4" in tabs and info["cache"] is None
    assert not path.exists()
