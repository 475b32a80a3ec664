"""Artifact formats: proof.json, verifier.json, proving.key, inputs.

Schemas match the reference exactly (prover/src/groth16/format.rs):

  proof.json    = {"a":[x,y], "b":[[xc0,xc1],[yc0,yc1]], "c":[x,y],
                   "public_inputs":[dec strings]}          (format.rs:80-128)
  verifier.json = full VK incl. "ic" array + "input_names" (format.rs:130-194)
  proving.key   = [u32 BE len][ASTs] + [u32 count] x [u32 len][QEQ]
                  + [u32 count][u32 ids...] + parameters    (format.rs:223-293)

The parameters section follows the bellman Parameters<Bn256> layout:
uncompressed big-endian affine points (G1 64B, G2 128B with c1 before
c0), vk head then h/l/a/b_g1/b_g2 vectors each prefixed with a u32 BE
count. Infinity encodes as 0x40 in the leading byte.

``read_pk(raw_queries=True)`` parses the query vectors as raw limb
arrays (``RawG1Query``, ``RawG2Query``) instead of point lists.
"""

from __future__ import annotations

import json
import struct
from typing import BinaryIO

import numpy as np

from ..algebra import FS, AlgebraError
from ..compiler.constraints import Constraints
from ..curve import (
    Fq2, G1Point, G2Point, Q, g1_is_on_curve, g2_is_on_curve,
    g2_is_in_subgroup,
)
from . import bincode
from .r1cs import R1CS
from .setup import Groth16Parameters, VerifyingKey


class FormatError(Exception):
    """A proving key, proof or verifying key whose contents break its
    format.  Raw queries are parsed without per-point checks; staging
    checks them against the curve (engine.GpuEngine)."""


# -- point <-> decimal-string JSON structs (format.rs:38-78) ------------------


def g1_to_jstruct(p: G1Point) -> list[str]:
    if p is None:
        raise FormatError("invalid point")
    return [str(p[0]), str(p[1])]


def g1_from_jstruct(j) -> G1Point:
    p = (_parse_fq(j[0]), _parse_fq(j[1]))
    if not g1_is_on_curve(p):
        raise FormatError(f"bad coordinates ({j[0]},{j[1]})")
    return p


def g2_to_jstruct(p: G2Point) -> list[list[str]]:
    if p is None:
        raise FormatError("invalid point")
    x, y = p
    return [[str(x.c0), str(x.c1)], [str(y.c0), str(y.c1)]]


def g2_from_jstruct(j) -> G2Point:
    """Checked G2 deserialization: on-curve AND r-subgroup.

    BN254 G2 has a large cofactor, so an on-curve point need not lie in
    the order-r subgroup -- a hostile proof B or vk point outside it is
    exactly what checked deserialization rejects (the reference reads
    with checks: Parameters::read(pk, true), format.rs:285).  G1 needs
    no subgroup check: the BN254 G1 cofactor is 1."""
    x = Fq2(_parse_fq(j[0][0]), _parse_fq(j[0][1]))
    y = Fq2(_parse_fq(j[1][0]), _parse_fq(j[1][1]))
    p = (x, y)
    if not g2_is_on_curve(p):
        raise FormatError(f"bad g2 coordinates {j}")
    if not g2_is_in_subgroup(p):
        raise FormatError("g2 point not in the r-order subgroup")
    return p


def _parse_fq(s: str) -> int:
    try:
        v = int(s, 16) if s.startswith("0x") else int(s, 10)
    except ValueError as exc:
        raise FormatError(f"{s} is not a number") from exc
    return v % Q


# -- proof.json ---------------------------------------------------------------


def proof_to_json(proof, public_inputs: list[tuple[str, FS]]) -> str:
    return json.dumps(
        {
            "a": g1_to_jstruct(proof.a),
            "b": g2_to_jstruct(proof.b),
            "c": g1_to_jstruct(proof.c),
            "public_inputs": [str(v) for _, v in public_inputs],
        },
        separators=(",", ":"),
    )


def proof_from_json(s: str):
    from .prove import Proof

    try:
        d = json.loads(s)
    except json.JSONDecodeError as exc:
        raise FormatError(str(exc)) from exc
    proof = Proof(
        a=g1_from_jstruct(d["a"]),
        b=g2_from_jstruct(d["b"]),
        c=g1_from_jstruct(d["c"]),
    )
    inputs = [int(x) for x in d["public_inputs"]]
    return proof, inputs


# -- verifier.json ------------------------------------------------------------


def vk_to_json(vk: VerifyingKey, input_names: list[str]) -> str:
    return json.dumps(
        {
            "alpha_g1": g1_to_jstruct(vk.alpha_g1),
            "beta_g1": g1_to_jstruct(vk.beta_g1),
            "beta_g2": g2_to_jstruct(vk.beta_g2),
            "delta_g1": g1_to_jstruct(vk.delta_g1),
            "delta_g2": g2_to_jstruct(vk.delta_g2),
            "gamma_g2": g2_to_jstruct(vk.gamma_g2),
            "ic": [g1_to_jstruct(p) for p in vk.ic],
            "input_names": input_names,
        },
        separators=(",", ":"),
    )


def vk_from_json(s: str) -> tuple[VerifyingKey, list[str]]:
    try:
        d = json.loads(s)
    except json.JSONDecodeError as exc:
        raise FormatError(str(exc)) from exc
    vk = VerifyingKey(
        alpha_g1=g1_from_jstruct(d["alpha_g1"]),
        beta_g1=g1_from_jstruct(d["beta_g1"]),
        beta_g2=g2_from_jstruct(d["beta_g2"]),
        gamma_g2=g2_from_jstruct(d["gamma_g2"]),
        delta_g1=g1_from_jstruct(d["delta_g1"]),
        delta_g2=g2_from_jstruct(d["delta_g2"]),
        ic=[g1_from_jstruct(p) for p in d["ic"]],
    )
    return vk, list(d.get("input_names", []))


# -- uncompressed point encoding ----------------------------------------------


def g1_to_bytes(p: G1Point) -> bytes:
    if p is None:
        return bytes([0x40]) + bytes(63)
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def g1_from_bytes(b: bytes) -> G1Point:
    if b[0] & 0x40:
        return None
    x = int.from_bytes(b[0:32], "big")
    y = int.from_bytes(b[32:64], "big")
    p = (x, y)
    if not g1_is_on_curve(p):
        raise FormatError("g1 point not on curve")
    return p


def g2_to_bytes(p: G2Point) -> bytes:
    if p is None:
        return bytes([0x40]) + bytes(127)
    x, y = p
    return (
        x.c1.to_bytes(32, "big")
        + x.c0.to_bytes(32, "big")
        + y.c1.to_bytes(32, "big")
        + y.c0.to_bytes(32, "big")
    )


def g2_from_bytes(b: bytes, subgroup_check: bool = False) -> G2Point:
    if b[0] & 0x40:
        return None
    x = Fq2(int.from_bytes(b[32:64], "big"), int.from_bytes(b[0:32], "big"))
    y = Fq2(int.from_bytes(b[96:128], "big"), int.from_bytes(b[64:96], "big"))
    p = (x, y)
    if not g2_is_on_curve(p):
        raise FormatError("g2 point not on curve")
    if subgroup_check and not g2_is_in_subgroup(p):
        raise FormatError("g2 point not in the r-order subgroup")
    return p


# -- raw (vectorized) query parsing -------------------------------------------
# Query vectors dominate pk size (millions of points at 2^20); parsing
# them point-by-point through Python ints with per-point curve checks
# costs minutes. The raw path slices the byte stream straight into
# (16, n) u16-limb numpy arrays (one frombuffer + byteswap view); the
# curve-membership check moves onto the device at staging time
# (GpuEngine.stage_params), keeping checked-deserialization parity
# with Parameters::read(pk, true) at array speed.

G1_KEYS = ("x", "y", "z")
G2_KEYS = ("x0", "x1", "y0", "y1", "z0")


class RawG1Query:
    """G1 query vector as projective limb arrays: x/y/z (16, n) u32 of
    16-bit plain limbs, infinity slots encoded as (0 : 1 : 0)."""

    def __init__(self, x, y, z):
        self.x, self.y, self.z = (np.asarray(a, np.uint32) for a in (x, y, z))

    def __len__(self):
        return self.x.shape[1]

    def expand(self, dense) -> "RawG1Query":
        """Density-filtered query -> one column per variable."""
        if len(self) == len(dense):
            return self
        idx = np.nonzero(np.asarray(dense, dtype=bool))[0]
        if len(idx) != len(self):
            raise FormatError("query length matches neither num_vars "
                              "nor density count")
        out = {k: np.zeros((16, len(dense)), np.uint32) for k in G1_KEYS}
        out["y"][0] = 1
        for k in G1_KEYS:
            out[k][:, idx] = getattr(self, k)
        return RawG1Query(**out)

    def to_points(self) -> list:
        from ..engine.field import limbs_to_ints

        xs, ys = limbs_to_ints(self.x), limbs_to_ints(self.y)
        inf = self.z[0] == 0
        return [None if inf[j] else (xs[j], ys[j]) for j in range(len(self))]


class RawG2Query:
    """G2 query vector as flat-Fq2 projective limb arrays: x0/x1/y0/y1
    (16, n) u32 (+ implicit z = (1, 0) or identity)."""

    def __init__(self, x0, x1, y0, y1, z0):
        self.x0, self.x1, self.y0, self.y1, self.z0 = (
            np.asarray(a, np.uint32) for a in (x0, x1, y0, y1, z0))

    def __len__(self):
        return self.x0.shape[1]

    def expand(self, dense) -> "RawG2Query":
        if len(self) == len(dense):
            return self
        idx = np.nonzero(np.asarray(dense, dtype=bool))[0]
        if len(idx) != len(self):
            raise FormatError("query length matches neither num_vars "
                              "nor density count")
        out = {k: np.zeros((16, len(dense)), np.uint32) for k in G2_KEYS}
        out["y0"][0] = 1
        for k in G2_KEYS:
            out[k][:, idx] = getattr(self, k)
        return RawG2Query(**out)

    def to_points(self) -> list:
        from ..engine.field import limbs_to_ints

        x0, x1, y0, y1 = (limbs_to_ints(getattr(self, k))
                          for k in G2_KEYS[:4])
        inf = self.z0[0] == 0
        return [None if inf[j] else (Fq2(x0[j], x1[j]), Fq2(y0[j], y1[j]))
                for j in range(len(self))]


def _read_g1_vec_raw(f: BinaryIO) -> RawG1Query:
    n = _r_u32be(f)
    buf = f.read(64 * n)
    if len(buf) != 64 * n:
        raise FormatError("truncated g1 query vector")
    if n == 0:
        return RawG1Query(*(np.zeros((16, 0), np.uint32),) * 3)
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(n, 64)
    inf = (raw[:, 0] & 0x40) != 0
    # 32-byte BE coords -> little-endian u16 limb rows
    u16 = np.frombuffer(buf, dtype=">u2").reshape(n, 2, 16)[:, :, ::-1]
    x = np.ascontiguousarray(u16[:, 0].T).astype(np.uint32)
    y = np.ascontiguousarray(u16[:, 1].T).astype(np.uint32)
    x[:, inf] = 0
    y[:, inf] = 0
    y[0, inf] = 1
    z = np.zeros((16, n), np.uint32)
    z[0] = (~inf).astype(np.uint32)
    return RawG1Query(x, y, z)


def _read_g2_vec_raw(f: BinaryIO) -> RawG2Query:
    n = _r_u32be(f)
    buf = f.read(128 * n)
    if len(buf) != 128 * n:
        raise FormatError("truncated g2 query vector")
    if n == 0:
        return RawG2Query(*(np.zeros((16, 0), np.uint32),) * 5)
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(n, 128)
    inf = (raw[:, 0] & 0x40) != 0
    u16 = np.frombuffer(buf, dtype=">u2").reshape(n, 4, 16)[:, :, ::-1]
    # wire order: x.c1, x.c0, y.c1, y.c0
    x1 = np.ascontiguousarray(u16[:, 0].T).astype(np.uint32)
    x0 = np.ascontiguousarray(u16[:, 1].T).astype(np.uint32)
    y1 = np.ascontiguousarray(u16[:, 2].T).astype(np.uint32)
    y0 = np.ascontiguousarray(u16[:, 3].T).astype(np.uint32)
    for a in (x0, x1, y0, y1):
        a[:, inf] = 0
    y0[0, inf] = 1
    z0 = np.zeros((16, n), np.uint32)
    z0[0] = (~inf).astype(np.uint32)
    return RawG2Query(x0, x1, y0, y1, z0)


# -- bellman-layout parameters section ----------------------------------------


def _w_u32be(f: BinaryIO, v: int):
    f.write(struct.pack(">I", v))


def _r_u32be(f: BinaryIO) -> int:
    return struct.unpack(">I", f.read(4))[0]


def write_parameters(f: BinaryIO, params: Groth16Parameters,
                     densities=None):
    """bellman `Parameters::write` layout. With densities=(a_d, b_d)
    (from R1CS.densities) the a/b_g1/b_g2 query vectors are
    density-filtered exactly as bellman's DensityTracker stores them;
    without, full per-variable vectors are written (in-memory/legacy)."""
    vk = params.vk
    f.write(g1_to_bytes(vk.alpha_g1))
    f.write(g1_to_bytes(vk.beta_g1))
    f.write(g2_to_bytes(vk.beta_g2))
    f.write(g2_to_bytes(vk.gamma_g2))
    f.write(g1_to_bytes(vk.delta_g1))
    f.write(g2_to_bytes(vk.delta_g2))
    _w_u32be(f, len(vk.ic))
    for p in vk.ic:
        f.write(g1_to_bytes(p))

    a, b_g1, b_g2 = params.a, params.b_g1, params.b_g2
    if densities is not None:
        a_d, b_d = densities
        a = [p for p, d in zip(a, a_d) if d]
        b_g1 = [p for p, d in zip(b_g1, b_d) if d]
        b_g2 = [p for p, d in zip(b_g2, b_d) if d]

    for vec in (params.h, params.l, a, b_g1):
        _w_u32be(f, len(vec))
        for p in vec:
            f.write(g1_to_bytes(p))
    _w_u32be(f, len(b_g2))
    for p in b_g2:
        f.write(g2_to_bytes(p))


def read_parameters(f: BinaryIO, checked: bool = False,
                    raw_queries: bool = False) -> Groth16Parameters:
    """All points are on-curve-validated (and G1 is cofactor-1, so
    on-curve implies subgroup); the VK-head G2 points are ALWAYS
    r-subgroup-checked (cheap, and they are the verification-critical
    material).  checked=True extends the subgroup check to the whole
    b_g2 query vector -- the reference's Parameters::read(pk, true)
    behavior (format.rs:285) at O(n) scalar-mul cost.

    raw_queries=True parses the h/l/a/b_g1/b_g2 vectors as Raw*Query
    limb arrays (vectorized, no per-point Python); their curve check
    then happens batched on device at engine staging time."""

    def g1v() -> list[G1Point]:
        n = _r_u32be(f)
        return [g1_from_bytes(f.read(64)) for _ in range(n)]

    alpha_g1 = g1_from_bytes(f.read(64))
    beta_g1 = g1_from_bytes(f.read(64))
    beta_g2 = g2_from_bytes(f.read(128), subgroup_check=True)
    gamma_g2 = g2_from_bytes(f.read(128), subgroup_check=True)
    delta_g1 = g1_from_bytes(f.read(64))
    delta_g2 = g2_from_bytes(f.read(128), subgroup_check=True)
    ic = g1v()
    if raw_queries:
        h = _read_g1_vec_raw(f)
        l = _read_g1_vec_raw(f)
        a = _read_g1_vec_raw(f)
        b_g1 = _read_g1_vec_raw(f)
        b_g2 = _read_g2_vec_raw(f)
    else:
        h = g1v()
        l = g1v()
        a = g1v()
        b_g1 = g1v()
        n = _r_u32be(f)
        b_g2 = [g2_from_bytes(f.read(128), subgroup_check=checked)
                for _ in range(n)]
    trailer = f.read(4)
    if len(trailer) == 4:
        domain_size = struct.unpack(">I", trailer)[0]
    else:
        domain_size = len(h) + 1
    if domain_size != len(h) + 1:
        raise FormatError("inconsistent domain size")
    vk = VerifyingKey(
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        gamma_g2=gamma_g2, delta_g1=delta_g1, delta_g2=delta_g2, ic=ic,
    )
    return Groth16Parameters(
        vk=vk, h=h, l=l, a=a, b_g1=b_g1, b_g2=b_g2, domain_size=domain_size
    )


# -- proving.key --------------------------------------------------------------


class ProvingKey:
    """Full pk: persisted compiler output + Groth16 parameters
    (format.rs:26-31)."""

    def __init__(
        self,
        asts: list,
        constraints: Constraints,
        ignore_signals: list[int],
        params: Groth16Parameters,
    ):
        self.asts = asts
        self.constraints = constraints
        self.ignore_signals = ignore_signals
        self.params = params


def write_pk(
    f: BinaryIO,
    asts: list,
    constraints: Constraints,
    ignore_signals: list[int],
    params: Groth16Parameters,
    densities=None,
):
    ast_serial = bincode.serialize_asts(asts)
    _w_u32be(f, len(ast_serial))
    f.write(ast_serial)

    _w_u32be(f, len(constraints))
    for i in range(len(constraints)):
        qeq = bincode.serialize_qeq(constraints.get(i))
        _w_u32be(f, len(qeq))
        f.write(qeq)

    _w_u32be(f, len(ignore_signals))
    for s in ignore_signals:
        _w_u32be(f, s)

    write_parameters(f, params, densities=densities)


def read_pk(f: BinaryIO, raw_queries: bool = False) -> ProvingKey:
    n = _r_u32be(f)
    asts = bincode.deserialize_asts(f.read(n))

    constraints = Constraints()
    count = _r_u32be(f)
    for _ in range(count):
        ln = _r_u32be(f)
        constraints.push(bincode.deserialize_qeq(f.read(ln)), None)

    count = _r_u32be(f)
    ignore_signals = [_r_u32be(f) for _ in range(count)]

    params = read_parameters(f, raw_queries=raw_queries)
    return ProvingKey(asts, constraints, ignore_signals, params)


# -- input flattening (format.rs:295-332) -------------------------------------


def flatten_json(prefix: str, json_str: str) -> list[tuple[str, FS]]:
    """input.json -> [("main.p", FS)] with array/object path mangling."""
    try:
        data = json.loads(json_str)
    except json.JSONDecodeError as exc:
        raise FormatError(str(exc)) from exc

    result: list[tuple[str, FS]] = []

    def flatten(prefix: str, v):
        if isinstance(v, list):
            for i, item in enumerate(v):
                flatten(f"{prefix}[{i}]", item)
        elif isinstance(v, dict):
            for key, item in v.items():
                flatten(f"{prefix}.{key}", item)
        elif isinstance(v, str):
            try:
                result.append((prefix, FS.parse(v)))
            except AlgebraError as exc:
                raise FormatError(str(exc)) from exc
        elif isinstance(v, bool):
            raise FormatError(f"Cannot decode value {v!r}")
        elif isinstance(v, int):
            if v < 0:
                raise FormatError(f"bad value {v}")
            result.append((prefix, FS(v)))
        else:
            raise FormatError(f"Cannot decode value {v!r}")

    flatten(prefix, data)
    return result
