"""The port's several-card path (za_tpu_torch.engine.mesh) on the CPU,
with zero tolerance: field values compared mod r, points normalized.

One group of 2 ranks and one of 4, spawned together once for the module
over gloo (tests/torch_mesh_ranks.py), each run every check: the sharded
four-step NTT, iNTT, coset NTT and h_transforms at m = 2^6 and 2^8
against za_tpu's host Domain and the port's one-device transforms; the
sharded tree MSM (S = 8, the chunk count padded to the mesh) and dense
MSM in G1 against za_tpu's HostEngine (the G2 MSMs of both routes are
held against the reference in tests/test_torch_dist.py's proofs, the
tree's with empty ranks); the sharded constraint
check on a true and a false witness and h(x) against HostEngine.
Without processes: the row partition against the reference's
_pack_rows_sharded_rns, the chunk pad against its formula, and the
mesh's refusals.
"""

import random

import numpy as np
import pytest
import torch

import za_tpu.engine.rns as RNS
from za_tpu.curve import G1_GEN as ZG1, g1_mul as z_g1_mul
from za_tpu.engine.engine import TpuEngine, _pad_pow2ish
from za_tpu.groth16.domain import Domain as ZDomain
from za_tpu.groth16.prove import HostEngine as ZHostEngine
from za_tpu.groth16.r1cs import R1CS as ZR1CS
from za_tpu_torch.curve import G1_GEN, R, g1_mul
from za_tpu_torch.engine import field as F, mesh as MESH, ntt as NTT
from za_tpu_torch.engine.engine import GpuEngine

import torch_mesh_ranks as RANKS

SIZES = (1 << 6, 1 << 8)
N_POINTS = 40
CHUNK = 8          # 5 chunks: padded to 6 at D = 2 and 8 at D = 4
N_CHAIN = 30


def _chain(n: int, seed: int = 5):
    """bench.py's chain t[i] = t[i-1]^2 + i: rows and a witness."""
    rng = random.Random(seed)
    a, b, c = [], [], []
    z = [1, rng.randrange(1, R)]
    for i in range(n):
        a.append([(i + 1, 1)])
        b.append([(i + 1, 1)])
        c.append([(i + 2, 1), (0, (-i) % R)])
        z.append((z[i + 1] * z[i + 1] + i) % R)
    return {"a": a, "b": b, "c": c, "z": z}


def _data():
    rng = random.Random(2026)
    ntt_in = {m: [[rng.randrange(R) for _ in range(m)] for _ in range(3)]
              for m in SIZES}
    for legs in ntt_in.values():
        legs[0][:2] = [0, R - 1]
    logs1 = [rng.randrange(1, R) for _ in range(N_POINTS)]
    sc = [[rng.randrange(R) for _ in range(N_POINTS)] for _ in range(2)]
    sc[0][:3] = [0, 1, R - 1]
    rows = _chain(N_CHAIN)
    z_false = list(rows["z"])
    z_false[7] = (z_false[7] + 1) % R
    rows["z_false"] = z_false
    data = {
        "ntt": ntt_in, "chunk": CHUNK, "r1cs": rows,
        "g1": {"points": [[g1_mul(G1_GEN, s) for s in logs1]] * 2,
               "scalars": sc},
    }
    return data, [z_g1_mul(ZG1, s) for s in logs1]


@pytest.fixture(scope="module")
def groups():
    data, ref = _data()
    started = {D: RANKS.start(RANKS.mesh_checks, D, data) for D in (2, 4)}
    return {D: RANKS.collect(g) for D, g in started.items()}, data, ref


@pytest.mark.parametrize("D", [2, 4])
def test_every_rank_agrees(groups, D):
    res = groups[0][D]
    assert [r["rank"] for r in res] == list(range(D))
    keys = [k for k in res[0] if k not in ("rank", "stats")]
    for r in res[1:]:
        for k in keys:
            assert r[k] == res[0][k], (k, r["rank"])
    # the three collectives ran; every rank sent as much as the others
    stats = res[0]["stats"]
    assert {"all_to_all", "all_gather", "all_reduce"} <= set(stats)
    assert all(r["stats"] == stats for r in res)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_transforms_match_domain(groups, D):
    res, data = groups[0][D][0], groups[1]
    for m in SIZES:
        zd, got, legs = ZDomain(m), res["ntt"][m], data["ntt"][m]
        for k, fn in (("ntt", zd.ntt), ("intt", zd.intt),
                      ("coset_ntt", zd.coset_ntt)):
            assert got[k] == [fn(v) for v in legs], (m, k)
        a, b, c = (zd.coset_ntt(zd.intt(v)) for v in legs)
        want = zd.coset_intt([(x * y - w) * zd.z_coset_inv % R
                              for x, y, w in zip(a, b, c)])
        assert got["h"] == want, m
        # and the port's one-device transforms
        dom = NTT.DeviceDomain(m, "cpu")
        x = torch.stack([RANKS._mont32(v) for v in legs], dim=1)
        one = NTT.h_transforms(dom, x)
        assert F.limbs_to_ints(one.numpy()) == got["h"]
        one = NTT.transform(dom, x, False, scale_in=dom.coset_pow)
        assert [RANKS._ints_mont32(r) for r in one.unbind(1)] == \
            got["coset_ntt"]


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_msms_match_host_engine(groups, D):
    res, data, ref = groups[0][D][0], groups[1], groups[2]
    C = -(-N_POINTS // CHUNK)
    assert res["layout"] == [-(-C // D), CHUNK]    # whole padded chunks
    want = [ZHostEngine().msm_g1(ref, s) for s in data["g1"]["scalars"]]
    assert res["tree_g1"] == want
    assert res["dense_g1"] == want


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_check_and_h(groups, D):
    res, rows = groups[0][D][0], groups[1]["r1cs"]
    assert res["sat_true"] is True and res["sat_false"] is False
    r1cs = ZR1CS(num_inputs=2, num_aux=N_CHAIN, input_names=["main.x"],
                 a_rows=rows["a"], b_rows=rows["b"], c_rows=rows["c"])
    m = ZDomain.for_constraints(N_CHAIN + 2).size
    assert m % (D * D) == 0       # the sharded path, not the whole one
    assert res["h_coeffs"] == ZHostEngine().h_coeffs(r1cs, rows["z"],
                                                     ZDomain(m))


# -- without processes ----------------------------------------------------------


def _csr_rows(csr, leg: int):
    """Local rows of one leg -> [[(var, coeff), ...], ...]."""
    ptr, cols = csr.row_ptr.tolist(), csr.cols.tolist()
    coeffs = F.l32_to_ints(csr.coeffs.numpy())
    r2inv = pow(F.FR.r2, -1, R)
    return [[(cols[e], coeffs[e] * r2inv % R)
             for e in range(ptr[k], ptr[k + 1])]
            for k in range(leg * csr.m, (leg + 1) * csr.m)]


@pytest.mark.parametrize("D", [2, 4])
def test_row_partition_matches_reference(D):
    rows = _chain(N_CHAIN)
    r1cs = ZR1CS(num_inputs=2, num_aux=N_CHAIN, input_names=["main.x"],
                 a_rows=rows["a"], b_rows=rows["b"], c_rows=rows["c"])
    m = ZDomain.for_constraints(N_CHAIN + 2).size
    m_loc = m // D
    for leg, name in enumerate("abc"):
        want = TpuEngine._pack_rows_sharded_rns(rows[name], m, D)
        for d in range(D):
            csr = MESH.shard_csr(r1cs, m, MESH.Mesh(D, d, "gloo"), "cpu")
            got = _csr_rows(csr, leg)
            if name == "a":    # the input-preservation rows n, n + 1
                for k in range(m_loc):
                    if N_CHAIN <= d * m_loc + k < N_CHAIN + 2:
                        assert got[k] == [(d * m_loc + k - N_CHAIN, 1)]
                        got[k] = []
            ents = [(k, v, c) for k, row in enumerate(got) for v, c in row]
            nnz = len(ents)
            assert want[1][d, :nnz].tolist() == [v for _, v, _ in ents]
            assert want[2][d, :nnz].tolist() == [k for k, _, _ in ents]
            assert np.array_equal(
                want[0][d, :, :nnz],
                RNS.RR.ints_to_rns([c * RNS.RR.m1 % R for _, _, c in ents]))
            assert not want[1][d, nnz:].any()


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 40, 1 << 15, (1 << 17) + 2, 1 << 19])
def test_chunk_pad_matches_reference(D, n):
    eng = GpuEngine(device="cpu",
                    mesh=MESH.Mesh(D, D - 1, "gloo") if D > 1 else None)
    for chunk in (None, 8):
        S = min(chunk or TpuEngine._tree_chunk(None, n), _pad_pow2ish(n))
        C = -(-n // S)
        C = -(-C // D) * D
        assert eng._layout(n, chunk) == (S, C)


def test_mesh_refusals(monkeypatch):
    with pytest.raises(RuntimeError, match="power of two"):
        MESH.make_mesh(3)
    with pytest.raises(RuntimeError, match="mesh needs 2 ranks"):
        MESH.make_mesh(2, backend="gloo")
    # NCCL runs one rank a card: never a quiet switch to gloo
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="mesh needs 2 devices, have 1"):
        MESH.make_mesh(2, backend="nccl")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="mesh needs 4 devices, have 1"):
        MESH.make_mesh(4, backend="nccl")
    assert not torch.distributed.is_initialized()
    # the engine: CUDA unless asked for the CPU, the default style only
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GpuEngine(mesh=2)
    with pytest.raises(ValueError, match="mesh requires msm_style=None"):
        GpuEngine(device="cpu", msm_style="fused",
                  mesh=MESH.Mesh(2, 0, "gloo"))
