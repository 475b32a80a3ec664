"""The port's several-card prove and its wiring on the CPU: ranks spawned
over gloo (tests/torch_mesh_ranks.py) prove the 30-constraint chain of
tests/torch_chain_pk.py through helper.prove with
GpuEngine(device="cpu", mesh=...), the staged gate lowered to the chain's
size inside the ranks: a group of 2 on the dense route and a group of 4
on the tree route (TREE_MIN 0: the one chunk padded to four, three ranks
with an empty chunk), started together once for the module.  Every
rank's proof.json equals za_tpu's (its HostEngine with the same r, s)
and verifies; rank 0 alone writes the trace, each rank its own table
cache.  Without processes: ZA_DIST, torchrun's variables and ZA_MESH
parsed as the reference parses them, the CLI's --mesh wiring, and a
table cache of another (D, rank) refused."""

import importlib
import json
import os
import shutil

import pytest
import torch

import za_tpu.cli as zcli
import za_tpu.engine.dist as zdist
from za_tpu_torch import cli
from za_tpu_torch.engine import dist, engine as engine_mod, msm_tree as MT
from za_tpu_torch.engine.mesh import Mesh
from za_tpu_torch.groth16 import helper

import torch_chain_pk as CHAIN
import torch_mesh_ranks as RANKS

ROUTES = {2: "dense", 4: "tree"}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    return CHAIN.build(str(tmp_path_factory.mktemp("chain")))


@pytest.fixture(scope="module")
def groups(chain, tmp_path_factory):
    started, dirs = {}, {}
    for D, route in ROUTES.items():
        d = dirs[D] = str(tmp_path_factory.mktemp(f"mesh{D}"))
        shutil.copy(os.path.join(chain["dir"], "proving.key"), d)
        started[D] = RANKS.start(RANKS.prove_checks, D, d,
                                 CHAIN.STAGED_GATE, CHAIN.INPUT_X,
                                 list(CHAIN.RS), route == "tree")
    return {D: RANKS.collect(g) for D, g in started.items()}, dirs


@pytest.mark.parametrize("D", [2, 4], ids=["2-dense", "4-tree"])
def test_mesh_prove_equals_reference(chain, groups, D):
    res = groups[0][D]
    assert [r["rank"] for r in res] == list(range(D))
    for r in res:
        assert r["proof"] == chain["proof_json"]
    assert helper.verify(chain["vk_json"], res[0]["proof"])


@pytest.mark.parametrize("D", [2, 4], ids=["2-dense", "4-tree"])
def test_mesh_prove_files(groups, D):
    res, d = groups[0][D], groups[1][D]
    caches = [f"proving.key.gpucache-mesh{D}-rank{r}" for r in range(D)]
    files = ["proving.key", "proving.key.wtrace"]
    if ROUTES[D] == "tree":
        files += caches
        for r in range(D):
            meta = json.loads(open(os.path.join(
                d, caches[r], "meta.json")).read())
            assert (meta["mesh_d"], meta["rank"]) == (D, r)
            assert {t["chunks"] for t in meta["tables"].values()} == {1}
            assert (res[r]["stage_info"]["source"],
                    res[r]["stage_info"]["cache"]) == ("staged", "miss")
    assert all(r["files"] == sorted(files) for r in res)


# -- without processes ----------------------------------------------------------


def _clean_env(monkeypatch):
    for k in ("ZA_DIST", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "ZA_MESH"):
        monkeypatch.delenv(k, raising=False)


def _reference_spec(monkeypatch):
    """What za_tpu's init_distributed hands jax.distributed.initialize:
    (coordinator, num_processes, process_id), or None."""
    import jax

    seen = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.append(kw))
    if not zdist.init_distributed():
        return None
    kw = seen[0]
    return (kw["coordinator_address"], kw["num_processes"],
            kw["process_id"])


@pytest.mark.parametrize("spec", [
    "10.0.0.1:1234,4,3", "localhost:29500,2,0", "h:1,1,0", "bad",
    "h:1,two,0", "h:1,2"])
def test_za_dist_parsed_as_the_reference(monkeypatch, spec):
    _clean_env(monkeypatch)
    monkeypatch.setenv("ZA_DIST", spec)
    try:
        want = _reference_spec(monkeypatch)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            dist.dist_spec()
        assert str(got.value) == str(exc)
        return
    got = dist.dist_spec()
    assert (got if got[1] > 1 else None) == want
    if want is None:      # one process: nothing to join
        assert dist.init_distributed() is False


@pytest.mark.parametrize("env", [
    {"addr": "10.0.0.2", "port": "4000", "world": "8", "rank": "5"},
    {"addr": "h", "port": "7", "world": None, "rank": None}])
def test_torchrun_variables_parsed_as_the_reference_jax_ones(monkeypatch,
                                                             env):
    _clean_env(monkeypatch)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS",
                       f"{env['addr']}:{env['port']}")
    monkeypatch.setenv("MASTER_ADDR", env["addr"])
    monkeypatch.setenv("MASTER_PORT", env["port"])
    for jax_var, var, key in (("JAX_NUM_PROCESSES", "WORLD_SIZE", "world"),
                              ("JAX_PROCESS_ID", "RANK", "rank")):
        if env[key] is not None:
            monkeypatch.setenv(jax_var, env[key])
            monkeypatch.setenv(var, env[key])
    want = _reference_spec(monkeypatch)
    got = dist.dist_spec()
    assert (got if got[1] > 1 else None) == want
    if want is None:
        assert dist.init_distributed() is False


def test_no_group_without_variables(monkeypatch):
    _clean_env(monkeypatch)
    assert dist.dist_spec() is None
    assert dist.init_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("raw", [None, "4", "0", "x4"])
def test_mesh_default_parsed_as_the_reference(monkeypatch, capsys, raw):
    _clean_env(monkeypatch)
    if raw is not None:
        monkeypatch.setenv("ZA_MESH", raw)
    want = zcli._mesh_default()
    want_err = capsys.readouterr().err
    assert cli._mesh_default() == want
    assert capsys.readouterr().err == want_err


@pytest.mark.parametrize("cmd", ["setup", "prove"])
def test_mesh_needs_the_gpu_engine(monkeypatch, tmp_path, cmd):
    _clean_env(monkeypatch)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "input.json").write_text('{"x": "3"}')
    with pytest.raises(SystemExit, match="--mesh requires --engine gpu"):
        cli.main([cmd, "--engine", "host", "--mesh", "2"])
    monkeypatch.setenv("ZA_MESH", "2")
    with pytest.raises(SystemExit, match="--mesh requires --engine gpu"):
        cli.main([cmd, "--engine", "host"])


class _FakeEngine:
    built: list = []

    def __init__(self, **kw):
        self.kw = kw
        self.rank = int(os.environ["ZA_DIST"].rsplit(",", 1)[1])
        _FakeEngine.built.append(self)


def test_cli_prove_mesh_wiring(monkeypatch, tmp_path):
    _clean_env(monkeypatch)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "input.json").write_text('{"x": "3"}')
    joined, proved, spawned = [], [], []
    monkeypatch.setattr(dist, "init_distributed", lambda: joined.append(1))
    monkeypatch.setattr(engine_mod, "GpuEngine", _FakeEngine)
    monkeypatch.setattr(helper, "prove", lambda pk, inputs, engine: (
        proved.append(engine) or "PROOF"))
    monkeypatch.setattr(cli, "_run_ranks",
                        lambda argv, n: spawned.append((argv, n)) or 7)
    _FakeEngine.built.clear()
    # one rank of the group ZA_DIST names: rank 1 proves, writes nothing
    monkeypatch.setenv("ZA_DIST", "127.0.0.1:5000,2,1")
    assert cli.main(["prove", "--mesh", "2"]) == 0
    assert joined and not spawned and not (tmp_path / "proof.json").exists()
    assert _FakeEngine.built[-1].kw == {"mesh": 2}
    assert proved == _FakeEngine.built
    # rank 0 writes the proof; --mesh defaults to the group's size
    monkeypatch.setenv("ZA_DIST", "127.0.0.1:5000,2,0")
    assert cli.main(["prove"]) == 0
    assert _FakeEngine.built[-1].kw == {"mesh": 2}
    assert (tmp_path / "proof.json").read_text() == "PROOF"
    # a size that is not the group's
    with pytest.raises(SystemExit, match="has 2 ranks"):
        cli.main(["prove", "--mesh", "4"])
    # --mesh alone starts the local ranks, each running the command
    monkeypatch.delenv("ZA_DIST")
    assert cli.main(["prove", "--mesh", "2", "--pk", "k"]) == 7
    assert spawned == [(["prove", "--mesh", "2", "--pk", "k"], 2)]
    assert len(_FakeEngine.built) == 2


def _tables():
    """One rank's tables of one 16-point chunk (the layout of 16 points
    over two ranks), zeros."""
    def table(is_g2):
        E = (8, 2) if is_g2 else (8,)
        t = torch.zeros((1, MT.HALF) + E + (1, 16), dtype=torch.int32)
        return MT.AffineTables(tx=t, ty=t.clone(), ident=torch.zeros(
            (1, 1, 16), dtype=torch.bool), n=16, is_g2=is_g2)
    return {name: table(name == "b_g2x") for name in engine_mod.TREE_TABLES}


def test_cache_of_another_layout_refused(tmp_path):
    """A cache saved by one (D, rank) loads under it alone: the key holds
    the mesh's size and the rank, and each rank has its own path."""
    queries = {name: (16, 1) for name in engine_mod.TREE_TABLES}
    engines = {(D, r): engine_mod.GpuEngine(
        device="cpu", mesh=Mesh(D, r, "gloo") if D > 1 else None)
        for D, r in ((1, 0), (2, 0), (2, 1))}
    base = str(tmp_path / "proving.key.gpucache")
    paths = {k: e._cache_path(base) for k, e in engines.items()}
    assert len(set(paths.values())) == 3 and paths[(1, 0)] == base
    saver = engines[(2, 1)]
    meta = saver._cache_meta("dd", queries)
    assert (meta["mesh_d"], meta["rank"]) == (2, 1)
    assert {t["chunks"] for t in meta["tables"].values()} == {1}
    saver._save_cache(paths[(2, 1)], meta, _tables(), {})
    for key, eng in engines.items():
        info = {}
        got = eng._load_cache(paths[(2, 1)], eng._cache_meta("dd", queries),
                              info)
        assert (got is not None) == (key == (2, 1)), key
        assert info["cache"] == ("hit" if key == (2, 1) else "stale")


def test_cli_local_ranks_run_the_command(chain, monkeypatch, tmp_path):
    """_run_ranks spawns the ranks (here on the CPU: no kernel to build),
    each running the command as rank r of ZA_DIST's group; a failing rank
    gives its exit code."""
    _clean_env(monkeypatch)
    (tmp_path / "vk.json").write_text(chain["vk_json"])
    good = json.loads(chain["proof_json"])
    (tmp_path / "good.json").write_text(json.dumps(good))
    good["public_inputs"][0] = str(int(good["public_inputs"][0]) + 1)
    (tmp_path / "bad.json").write_text(json.dumps(good))
    for proof, rc in (("good.json", 0), ("bad.json", 1)):
        assert cli._run_ranks(["verify", "--verifier",
                               str(tmp_path / "vk.json"), "--proof",
                               str(tmp_path / proof)], 2) == rc
