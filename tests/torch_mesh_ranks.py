"""The ranks of the port's several-card tests: a group of D processes,
spawned, joined over gloo on the CPU (a file:// rendezvous in a temp
dir of its own, so that test workers never share a port), each running
one function of this module and sending back what it returns.

The rank functions import only the port: spawned processes import this
module afresh, and monkeypatched module constants of the test process
do not reach them, so each sets its own (the staged gate, TREE_MIN).
"""

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

#: seconds a group may take, and a collective wait
GROUP_TIMEOUT = 240
GLOO_TIMEOUT = 120


def _rank(name: str, D: int, rank: int, rdv: str, q, args) -> None:
    import torch

    torch.set_num_threads(1)
    try:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{rdv}", world_size=D, rank=rank,
            timeout=timedelta(seconds=GLOO_TIMEOUT))
        q.put((rank, "ok", globals()[name](D, rank, *args)))
    except BaseException:  # noqa: BLE001 -- reported to the test
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def start(fn, D: int, *args):
    """Spawn the D ranks of a group running fn(D, rank, *args)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="za_mesh_")
    procs = [ctx.Process(target=_rank, args=(fn.__name__, D, r,
                                              os.path.join(tmp, "rdv"), q,
                                              args))
             for r in range(D)]
    for p in procs:
        p.start()
    return procs, q, tmp


def collect(group) -> list:
    """Each rank's result, in rank order; raises with a failing rank's
    traceback, or when the group outlasts GROUP_TIMEOUT.  Every process
    is ended on the way out."""
    procs, q, tmp = group
    got, deadline = {}, time.monotonic() + GROUP_TIMEOUT
    try:
        while len(got) < len(procs):
            try:
                rank, status, res = q.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise AssertionError(
                    f"mesh group: ranks {sorted(got)} of {len(procs)} "
                    f"answered in {GROUP_TIMEOUT} s") from None
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(len(procs))]


# -- conversions ---------------------------------------------------------------


def _mont32(vals):
    """Fr ints -> l32 Montgomery tensor (8, len)."""
    import torch

    from za_tpu_torch.engine import field as F

    return torch.from_numpy(F.ints_to_l32(
        [F.FR.to_mont_int(v) for v in vals]).copy())


def _ints_mont32(t) -> list:
    from za_tpu_torch.engine import field as F

    return F.limbs_to_ints(F.FR.from_mont(F.unpack(t).reshape(
        F.NLIMBS, -1)).numpy())


def _gather(mesh, t):
    """Every rank's shard (..., n/D) -> the whole (..., n), on every rank."""
    g = mesh.all_gather(t)                    # (D, ..., n/D)
    return g.movedim(0, -2).reshape(t.shape[:-1] + (-1,))


# -- test_torch_mesh: the sharded NTT, MSMs and check ----------------------------


def mesh_checks(D: int, rank: int, data: dict) -> dict:
    """The sharded transforms (on three legs a size), the tree and dense
    G1 MSMs of two queries (G2's run in prove_checks' proofs: a plain
    Horner costs the CPU ~5 s) and the constraint check and h(x) on a
    true and a false witness -> values as ints, gathered whole."""
    import torch

    from za_tpu_torch.engine import dist, field as F
    from za_tpu_torch.engine import mesh as MESH
    from za_tpu_torch.engine.engine import GpuEngine
    from za_tpu_torch.groth16.domain import Domain
    from za_tpu_torch.groth16.r1cs import R1CS

    mesh = MESH.make_mesh(D)
    out = {"rank": mesh.rank, "ntt": {}}
    for m, legs in data["ntt"].items():
        x = torch.stack([_mont32(v) for v in legs], dim=1)   # (8, 3, m)
        x = dist.shard_of(x, 2, rank, D)
        sd = MESH.ShardedDomain(m, mesh, "cpu")
        ys = {"ntt": MESH.transform(mesh, sd, x, False),
              "intt": MESH.transform(mesh, sd, x, True),
              "coset_ntt": MESH.transform(mesh, sd, x, False,
                                          scale_in=sd.coset_pow)}
        res = {k: [_ints_mont32(r) for r in _gather(mesh, y).unbind(1)]
               for k, y in ys.items()}
        h = _gather(mesh, MESH.h_transforms(mesh, sd, x))
        res["h"] = F.limbs_to_ints(h.numpy())
        out["ntt"][m] = res

    eng = GpuEngine(device="cpu", mesh=mesh)
    g1 = data["g1"]
    tabs = eng.stage_g1_affine(g1["points"], chunk=data["chunk"])
    out["layout"] = [tabs.chunks, tabs.chunk_cols]
    out["tree_g1"] = eng.msm_g1_many(tabs, g1["scalars"])
    out["dense_g1"] = eng.msm_g1_many(g1["points"], g1["scalars"])

    rows = data["r1cs"]
    r1cs = R1CS(num_inputs=2, num_aux=len(rows["z"]) - 2,
                input_names=["main.x"], a_rows=rows["a"], b_rows=rows["b"],
                c_rows=rows["c"])
    z = rows["z"]
    m = Domain.for_constraints(r1cs.num_constraints + 2).size
    out["sat_true"] = eng.r1cs_satisfied(r1cs, z)
    out["h_coeffs"] = eng.h_coeffs(r1cs, z, Domain(m))
    out["sat_false"] = eng.r1cs_satisfied(r1cs, rows["z_false"])
    out["stats"] = {k: v[:2] for k, v in mesh.stats.items()}
    return out


# -- test_torch_dist: the prove --------------------------------------------------


def prove_checks(D: int, rank: int, pk_dir: str, gate: int, x: int, rs,
                 tree: bool) -> dict:
    """helper.prove of the chain's pk in pk_dir by D ranks, the staged
    gate at the chain's size, on the tree route (TREE_MIN 0) or the dense
    one -> this rank's proof.json, its stage_info, and the files beside
    the pk after every rank proved."""
    import importlib

    from za_tpu_torch.algebra import FS
    from za_tpu_torch.engine import engine as engine_mod
    from za_tpu_torch.engine import mesh as MESH
    from za_tpu_torch.groth16 import helper

    prove_mod = importlib.import_module("za_tpu_torch.groth16.prove")
    prove_mod.STAGED_MIN = helper.STAGED_MIN = gate
    if tree:
        engine_mod.TREE_MIN = 0
    mesh = MESH.make_mesh(D)
    eng = engine_mod.GpuEngine(device="cpu", mesh=mesh)
    proof = helper.prove(os.path.join(pk_dir, "proving.key"),
                         [("main.x", FS(x))], engine=eng,
                         deterministic_rs=tuple(rs))
    mesh.all_true(True)                   # every rank has proved
    return {"proof": proof, "stage_info": dict(eng.stage_info),
            "rank": eng.rank, "files": sorted(os.listdir(pk_dir))}


# -- test_torch_cuda: two ranks sharing one card -----------------------------------


def cuda_checks(D: int, rank: int, data: dict) -> dict:
    """On the card, ranks sharing it over gloo: the sharded tree MSM in
    G1 and G2 (data's chunk width, the chunk count padded to D) and the
    sharded transforms and h(x) of three legs -> ints, gathered whole."""
    import torch

    from za_tpu_torch.engine import dist, field as F
    from za_tpu_torch.engine import mesh as MESH
    from za_tpu_torch.engine.engine import GpuEngine

    mesh = MESH.make_mesh(D)
    eng = GpuEngine(mesh=mesh)
    out = {"layout": []}
    for key, stage, msm in (("g1", eng.stage_g1_affine, eng.msm_g1_many),
                            ("g2", eng.stage_g2_affine, eng.msm_g2_many)):
        tabs = stage(data[key]["points"], chunk=data["chunk"])
        out["layout"].append([tabs.chunks, tabs.chunk_cols])
        out[key] = msm(tabs, data[key]["scalars"])
    m = data["m"]
    x = torch.stack([_mont32(v) for v in data["legs"]], dim=1).cuda()
    x = dist.shard_of(x, 2, rank, D)
    sd = MESH.ShardedDomain(m, mesh, x.device)
    for key, y in (("ntt", MESH.transform(mesh, sd, x, False)),
                   ("intt", MESH.transform(mesh, sd, x, True))):
        out[key] = [_ints_mont32(r) for r in _gather(mesh, y).cpu().unbind(1)]
    h = _gather(mesh, MESH.h_transforms(mesh, sd, x))
    out["h"] = F.limbs_to_ints(dist.fetch_replicated(h))
    return out
