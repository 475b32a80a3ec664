"""GpuEngine: the prover-facing compute facade on one CUDA device.

Provides the surface ``groth16.prove`` calls: ``stage_params``,
``use_grouped``, ``witness_limbs_dev``, ``r1cs_satisfied``,
``h_coeffs_limbs`` (and ``h_coeffs``), ``msm_g1_many``, ``msm_g2_many``,
``msm_g1``, ``msm_g2``, plus the staging calls ``stage_g1_affine`` /
``stage_g2_affine`` (tree) and ``stage_g1_stacked`` /
``stage_g2_stacked`` (dense) for callers that stage queries themselves,
and the setup's ``fixed_base_g1`` / ``fixed_base_g2`` (``[s_i G]`` by a
window table and one fixed-base MSM launch, ``engine.fixed_base``).
Raw limb-array queries (``groth16.format``) come without the host's
per-point check, so staging checks their points against the curve on
the device and raises ``FormatError`` (the reference's stage_params
with ``curve_check``).

MSM routing follows the reference's (za_tpu/engine/engine.py
stage_params): a pk whose padded a/b1/l length reaches ``TREE_MIN``
takes the batch-affine tree, with column chunks of 2^15 below 2^19
points and 2^14 above (the reference's _tree_chunk); a smaller one
takes the dense signed radix-16 kernel, its four G1 queries stacked as
one "g1x4".  ``msm_style="fused"`` takes the dense radix-4 kernel at
every size (the reference's "fused" style).

The engine runs on ``cuda`` unless the caller asks for another device
(the tests pass ``device="cpu"``, where every kernel wrapper takes its
plain version).  Without CUDA, ``GpuEngine()`` raises.

Staged-table cache: when ``groth16.helper.prove`` proves from a pk file
it sets ``params._gpucache_path`` (``<pk>.gpucache``) and
``params._gpucache_digest``; tree staging then loads the tables from
that directory (``.npy`` files and ``meta.json``) when its key matches,
or stages and saves them.  The key is the engine ("gpu"), the pk
digest, ``msm_style``, ``TREE_MIN``, each table's chunk layout and the
cache's version; a cache that misses the key or fails to load is
restaged.  ``stage_info`` says what the last ``stage_params`` did.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time

import numpy as np
import torch

from ..curve import G1_GEN, G2_GEN, R
from ..groth16 import format as FMT
from ..groth16.domain import Domain
from ..groth16.r1cs import R1CS
from ..groth16.setup import expand_queries
from . import cuda_tree as CT, ec, field as F, fixed_base as FB
from . import msm_dense as MD
from . import msm_tree as MT, ntt as NTT
from . import r1cs as RC


# columns per staging block: bounds the working set of the {1P..8P} build
STAGE_BLOCK = {False: 1 << 16, True: 1 << 15}

# padded query length from which the batch-affine tree beats the dense
# kernel (the reference's _tree_min, measured there on a TPU)
TREE_MIN = 1 << 15

# msm_style -> radix of the dense kernel
STYLES = {None: 16, "fused": 4}

# the staged-table cache's format; a cache of another version restages
GPUCACHE_VERSION = 1
TREE_TABLES = ("g1abl", "g1h", "b_g2x")

log = logging.getLogger("za_tpu_torch")


def _raw(queries) -> bool:
    """Whether staging checks these queries against the curve: raw
    limb-array queries come without the host's per-point check; point
    lists were checked when they were made."""
    return any(isinstance(q, (FMT.RawG1Query, FMT.RawG2Query))
               for q in queries)


def _pad_pow2(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size <<= 1
    return size


class GpuEngine:
    use_grouped = True

    def __init__(self, device=None, msm_style: str | None = None):
        if msm_style not in STYLES:
            raise ValueError(
                f"GpuEngine: msm_style {msm_style!r} is not ported: None "
                f"(tree, or dense signed radix 16 below TREE_MIN) or "
                f"'fused' (dense radix 4); 'dense' and 'grouped' are the "
                f"reference's XLA-only alternates")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GpuEngine: CUDA is not available")
        self.device = device
        self.msm_style = msm_style
        self.radix = STYLES[msm_style]
        self._domains: dict[int, NTT.DeviceDomain] = {}
        self._sat_legs = None
        self._witness = None
        #: what the last stage_params did: "source" ("memo": the tables
        #: already on params, "cache": loaded from <pk>.gpucache,
        #: "staged"), "cache" (None: no cache path, "hit", "miss" or
        #: "stale": a cache that missed the key or failed to load),
        #: "stage_s", and with a cache "cache_load_s" or
        #: "cache_save_s" and "cache_bytes"
        self.stage_info: dict = {}
        self._fb_tables: dict = {}
        #: what the last fixed_base_g1/g2 did: "n" scalars, seconds of
        #: "table_s" (0 when the (group, c) table was kept), "upload_s"
        #: (ints to limbs, to the device), "device_s" (the MSM and affine
        #: kernels, out of Montgomery form, up to a sync), "points_s" (to
        #: the host, host points)
        self.fixed_base_info: dict = {}

    @staticmethod
    def tree_chunk(n: int) -> int:
        return 1 << 14 if n >= (1 << 19) else 1 << 15

    # -- staging ---------------------------------------------------------------

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(arr).astype(np.int32)).to(self.device)

    def _layout(self, n: int, chunk: int | None) -> tuple[int, int]:
        """Chunk width S and chunk count C for n points per query."""
        S = min(chunk or self.tree_chunk(n), _pad_pow2(n))
        return S, -(-n // S)

    def _mont(self, limbs: np.ndarray) -> torch.Tensor:
        """(16, ...) plain host limbs -> (8, ...) l32 Montgomery."""
        return F.pack(F.FQ.to_mont(self._put(limbs).to(F.I64)))

    @staticmethod
    def _assert_on_curve(ok: torch.Tensor | None, is_g2: bool) -> None:
        """ok: a device flag, whether every checked point of one staging
        call lies on the curve (None: nothing checked); read once, after
        the call's last block, so the host prepares each block while the
        card checks the last.  FormatError with the reference's text
        unless it holds."""
        if ok is not None and not bool(ok):
            raise FMT.FormatError(
                f"pk {'g2' if is_g2 else 'g1'} query point not on curve")

    def _stage(self, coords, queries, n: int, is_g2: bool, S: int,
               C: int) -> MT.AffineTables:
        """coords(lo, hi) -> host (X, Y, Z) blocks (16, [2,] M*(hi-lo))
        of plain limbs -> chunked affine tables, block by block."""
        M = len(queries)
        block = S * max(STAGE_BLOCK[is_g2] // S, 1)
        E = (8, 2) if is_g2 else (8,)
        tx = torch.empty((C, MT.HALF) + E + (M, S), dtype=torch.int32,
                         device=self.device)
        ty = torch.empty_like(tx)
        ident = torch.empty((C, M, S), dtype=torch.bool, device=self.device)
        ok = (torch.ones((), dtype=torch.bool, device=self.device)
              if _raw(queries) else None)
        for lo in range(0, C * S, block):
            hi = min(lo + block, C * S)
            k = (hi - lo) // S
            pts = tuple(self._mont(c) for c in coords(lo, hi))
            if ok is not None:
                ok &= ec.on_curve(*pts, is_g2).all()
            ax, ay, idm = MT.build_tables_block(pts, is_g2)

            def chunks(a):  # (..., M*(hi-lo)) -> (k, ..., M, S)
                a = a.reshape(tuple(a.shape[:-1]) + (M, k, S))
                return a.movedim(-2, 0)

            tx[lo // S:lo // S + k] = chunks(ax)
            ty[lo // S:lo // S + k] = chunks(ay)
            ident[lo // S:lo // S + k] = chunks(idm)
        self._assert_on_curve(ok, is_g2)
        return MT.AffineTables(tx=tx, ty=ty, ident=ident, n=n, is_g2=is_g2)

    def stage_g1_affine(self, queries,
                        chunk: int | None = None) -> MT.AffineTables:
        """M G1 queries (point lists or raw limb-array queries) ->
        chunked affine {1P..8P} tables, staged block by block."""
        n = max(len(q) for q in queries)
        S, C = self._layout(n, chunk)
        cols = [_g1_coords(q, C * S) for q in queries]

        def coords(lo, hi):
            return tuple(np.concatenate([c[i][:, lo:hi] for c in cols], 1)
                         for i in range(3))

        return self._stage(coords, queries, n, False, S, C)

    def stage_g2_affine(self, queries,
                        chunk: int | None = None) -> MT.AffineTables:
        n = max(len(q) for q in queries)
        S, C = self._layout(n, chunk)
        cols = [_g2_coords(q, C * S) for q in queries]

        def coords(lo, hi):
            def cat(i):
                return np.concatenate([c[i][:, lo:hi] for c in cols], 1)
            # (16, 2, M*blk): component axis after the limbs
            return tuple(np.stack([cat(i), cat(i + 1)], axis=1)
                         for i in (0, 2, 4))

        return self._stage(coords, queries, n, True, S, C)

    def stage_g1_stacked(self, queries,
                         n_pad: int | None = None) -> MD.DenseTables:
        """M G1 queries (point lists or raw limb-array queries),
        identity-padded to n_pad (default: the longest) -> their
        multiples for the engine's dense radix, (K, 8, M, n)."""
        n = n_pad or max(1, *(len(q) for q in queries))
        cols = [_g1_coords(q, n) for q in queries]
        pts = [self._mont(np.concatenate([c[i] for c in cols], 1))
               .reshape(F.NL32, len(queries), n) for i in range(3)]
        ok = ec.on_curve(*pts, False).all() if _raw(queries) else None
        tables = MD.build_tables(pts, False, self.radix)
        self._assert_on_curve(ok, False)
        return tables

    def stage_g2_stacked(self, queries,
                         n_pad: int | None = None) -> MD.DenseTables:
        """-> (K, 8, 2, M, n): component axis after the limbs."""
        n = n_pad or max(1, *(len(q) for q in queries))
        cols = [_g2_coords(q, n) for q in queries]

        def coord(i):
            def cat(j):
                return np.concatenate([c[j] for c in cols], 1)
            both = np.stack([cat(i), cat(i + 1)], axis=1)  # (16, 2, M*n)
            return self._mont(both).reshape(F.NL32, 2, len(queries), n)

        pts = [coord(i) for i in (0, 2, 4)]
        ok = ec.on_curve(*pts, True).all() if _raw(queries) else None
        tables = MD.build_tables(pts, True, self.radix)
        self._assert_on_curve(ok, True)
        return tables

    def stage_params(self, params, r1cs: R1CS) -> dict:
        """Stage the pk queries once per process, cached on params under
        the device, the style and TREE_MIN (a params object staged by
        one engine is restaged, not reused, by an engine that routes
        otherwise).  Tree (padded a/b1/l length >= TREE_MIN, default
        style): a/b_g1/l share one G1 table group, h gets its own, b_g2
        its G2 tables; with ``params._gpucache_path`` set they come
        from, or go to, the staged-table cache.  Dense: the four G1
        queries padded to one power of two and stacked as "g1x4", b_g2
        as a stacked "b_g2x"."""
        cached = getattr(params, "_staged_cache", None)
        key = ("gpu", str(self.device), self.msm_style, TREE_MIN)
        if cached is not None and cached[0] == key:
            self.stage_info = {"source": "memo", "cache": None,
                               "stage_s": 0.0}
            return cached[1]
        t0 = time.monotonic()
        info = {"source": "staged", "cache": None}
        full = expand_queries(params, r1cs)
        n_abl = _pad_pow2(max(len(full.a), len(full.b_g1), len(full.l)))
        if self.msm_style is None and n_abl >= TREE_MIN:  # tree
            path = getattr(params, "_gpucache_path", None)
            meta = path and self._cache_meta(
                getattr(params, "_gpucache_digest", ""), {
                    "g1abl": (max(len(full.a), len(full.b_g1),
                                  len(full.l)), 3),
                    "g1h": (len(full.h), 1),
                    "b_g2x": (len(full.b_g2), 1)})
            staged = path and self._load_cache(path, meta, info)
            if staged:
                info["source"] = "cache"
            else:
                staged = {
                    "g1abl": self.stage_g1_affine(
                        [full.a, full.b_g1, full.l]),
                    "g1h": self.stage_g1_affine([full.h]),
                    "b_g2x": self.stage_g2_affine([full.b_g2]),
                }
                if path:
                    self._sync()
                    info["stage_s"] = time.monotonic() - t0
                    self._save_cache(path, meta, staged, info)
        else:
            n = _pad_pow2(max(n_abl, len(full.h)))
            staged = {
                "g1x4": self.stage_g1_stacked(
                    [full.a, full.b_g1, full.l, full.h], n),
                "b_g2x": self.stage_g2_stacked(
                    [full.b_g2], _pad_pow2(len(full.b_g2))),
            }
        self._sync()
        info.setdefault("stage_s", time.monotonic() - t0)
        self.stage_info = info
        params._staged_cache = (key, staged)
        return staged

    # -- the staged-table cache --------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cache_meta(self, digest: str, queries: dict) -> dict:
        """The cache's key: {table: (points per query, queries)} ->
        meta.json's contents, each table's chunk layout (S, C) in it."""
        tables = {}
        for name, (n, m) in queries.items():
            S, C = self._layout(n, None)
            tables[name] = {"n": n, "m": m, "chunk_cols": S, "chunks": C}
        return {"version": GPUCACHE_VERSION, "engine": "gpu",
                "digest": digest, "msm_style": self.msm_style,
                "tree_min": TREE_MIN, "tables": tables}

    def _load_cache(self, path: str, meta: dict, info: dict):
        """<pk>.gpucache -> the staged tables on the device, or None
        (info["cache"]: "miss" without a cache, "stale" for one that
        misses the key or fails to load)."""
        meta_path = os.path.join(path, "meta.json")
        if not os.path.exists(meta_path):
            info["cache"] = "miss"
            return None
        t0 = time.monotonic()
        try:
            with open(meta_path, encoding="utf-8") as f:
                if json.load(f) != meta:
                    raise ValueError("key differs")
            staged, nbytes = {}, 0
            for name in TREE_TABLES:
                tab = meta["tables"][name]
                E = (8, 2) if name == "b_g2x" else (8,)
                want = (tab["chunks"], MT.HALF) + E + (tab["m"],
                                                       tab["chunk_cols"])
                arrs = {}
                for part, shape, dtype in (
                        ("tx", want, np.int32), ("ty", want, np.int32),
                        ("id", want[:1] + want[-2:], np.bool_)):
                    a = np.load(os.path.join(path, f"{name}_{part}.npy"),
                                allow_pickle=False)
                    if a.shape != shape or a.dtype != dtype:
                        raise ValueError(f"{name}_{part}: {a.shape} "
                                         f"{a.dtype}, want {shape}")
                    nbytes += a.nbytes
                    arrs[part] = torch.from_numpy(a).to(self.device)
                staged[name] = MT.AffineTables(
                    tx=arrs["tx"], ty=arrs["ty"], ident=arrs["id"],
                    n=tab["n"], is_g2=name == "b_g2x")
            self._sync()
        except Exception as exc:  # noqa: BLE001 -- the cache is best-effort
            log.info("gpucache %s not loaded (%s); restaging", path, exc)
            info["cache"] = "stale"
            return None
        info.update(cache="hit", cache_load_s=time.monotonic() - t0,
                    cache_bytes=nbytes)
        return staged

    def _save_cache(self, path: str, meta: dict, staged: dict,
                    info: dict) -> None:
        """The staged tables -> <pk>.gpucache, written beside it and
        moved into place whole."""
        t0 = time.monotonic()
        tmp = path + ".tmp"
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            nbytes = 0
            for name in TREE_TABLES:
                t = staged[name]
                for part, a in (("tx", t.tx), ("ty", t.ty),
                                ("id", t.ident)):
                    a = a.cpu().numpy()
                    nbytes += a.nbytes
                    np.save(os.path.join(tmp, f"{name}_{part}.npy"), a,
                            allow_pickle=False)
            with open(os.path.join(tmp, "meta.json"), "w",
                      encoding="utf-8") as f:
                json.dump(meta, f, sort_keys=True)
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
        except OSError as exc:  # read-only pk dir: no cache
            log.info("gpucache %s not saved: %s", path, exc)
            shutil.rmtree(tmp, ignore_errors=True)
            return
        info.update(cache_save_s=time.monotonic() - t0, cache_bytes=nbytes)

    # -- fixed-base scalar multiplication (trusted setup) ------------------------

    def _fixed_base(self, scalars, c: int, is_g2: bool) -> list:
        """[s_i * G] as host affine points (None for s_i = 0 mod R): the
        (group, c) window table built once and kept on the engine, then
        one fixed-base MSM launch over all the scalars, to_affine and the
        points read back, infinity from Z."""
        if not len(scalars):    # to_affine takes no empty batch
            self.fixed_base_info = {"n": 0, "table_s": 0.0, "upload_s": 0.0,
                                    "device_s": 0.0, "points_s": 0.0}
            return []
        t0 = time.monotonic()
        table = self._fb_tables.get((is_g2, c))
        if table is None:
            base = ec.points_to_device([G2_GEN if is_g2 else G1_GEN], is_g2,
                                       self.device)
            table = self._fb_tables[(is_g2, c)] = FB.fixed_base_table(
                base, c, is_g2)
            self._sync()
        t1 = time.monotonic()
        sc = self._put(F.ints_to_limbs([s % R for s in scalars]))
        t2 = time.monotonic()
        X, Y, Z = FB.fixed_base_msm(table, sc, c, is_g2)
        x, y = ec.to_affine(X, Y, Z, is_g2)
        inf = (Z == 0).flatten(0, ec.elem_axes(is_g2) - 1).all(0)
        self._sync()
        t3 = time.monotonic()
        out = ec.affine_points_from_device(x, y, inf, is_g2)
        self.fixed_base_info = {
            "n": len(scalars), "table_s": t1 - t0, "upload_s": t2 - t1,
            "device_s": t3 - t2, "points_s": time.monotonic() - t3}
        return out

    def fixed_base_g1(self, scalars, c: int = 8) -> list:
        """[s_i * G1 for s_i]: the setup's pk-query builder (the
        reference's fixed_base_g1)."""
        return self._fixed_base(scalars, c, False)

    def fixed_base_g2(self, scalars, c: int = 8) -> list:
        return self._fixed_base(scalars, c, True)

    # -- witness, R1CS, h(x) -------------------------------------------------------

    def witness_limbs_dev(self, z) -> torch.Tensor:
        """Witness (list[int], (16, nv) array or tensor) -> (16, nv)
        int32 plain limbs on the device; one upload per witness object."""
        if isinstance(z, torch.Tensor):
            return z.to(self.device)
        if isinstance(z, np.ndarray):
            return self._put(z)
        if self._witness is not None and self._witness[0] is z:
            return self._witness[1]
        dev = self._put(F.ints_to_limbs([v % R for v in z]))
        self._witness = (z, dev)  # holding z keeps its id valid
        return dev

    def _legs(self, r1cs: R1CS, z, m: int) -> torch.Tensor:
        """The Az, Bz, Cz legs at domain size m, l32 (8, 3, m)
        Montgomery, Az with the input-preservation rows: the matvec on
        the uploaded (16, nv) witness limbs, nothing run before it."""
        return RC.matvec(RC.r1cs_csr(r1cs, m, self.device),
                         self.witness_limbs_dev(z))

    def r1cs_satisfied(self, r1cs: R1CS, z) -> bool:
        """Az o Bz == Cz on the device.  The Az/Bz/Cz legs are kept for
        an h(x) on the same r1cs and witness that follows."""
        m = Domain.for_constraints(r1cs.num_constraints
                                   + r1cs.num_inputs).size
        legs = self._legs(r1cs, z, m)
        self._sat_legs = ((id(r1cs), id(z), m), legs)
        return RC.satisfied(legs)

    def _domain(self, size: int) -> NTT.DeviceDomain:
        if size not in self._domains:
            self._domains[size] = NTT.DeviceDomain(size, self.device)
        return self._domains[size]

    def h_coeffs_limbs(self, r1cs: R1CS, z, domain: Domain) -> torch.Tensor:
        """h_0..h_{m-2} as (16, m-1) int32 plain limbs on the device:
        matvec (r1cs_matvec_fr), then iNTT, coset NTT and coset iNTT
        (NTT.h_transforms: the scalings, the combine and from_mont in the
        prefix kernel's modes)."""
        m = domain.size
        stash, self._sat_legs = self._sat_legs, None
        if stash is not None and stash[0] == (id(r1cs), id(z), m):
            legs = stash[1]
        else:
            legs = self._legs(r1cs, z, m)
        h = NTT.h_transforms(self._domain(m), legs)
        if bool(h[:, m - 1].any()):
            raise ValueError("h(x) degree overflow: witness unsatisfied?")
        return h[:, :m - 1]

    def h_coeffs(self, r1cs: R1CS, z, domain: Domain) -> list[int]:
        return F.limbs_to_ints(self.h_coeffs_limbs(r1cs, z, domain).cpu())

    # -- MSM -------------------------------------------------------------------

    def _scalars(self, tabs, scalars_list) -> torch.Tensor:
        """One scalar vector per staged query -> (16, M, n) plain limbs,
        zero-padded to the staged width n."""
        if isinstance(tabs, MT.AffineTables):
            n = tabs.chunks * tabs.chunk_cols
        else:
            n = tabs.n
        if len(scalars_list) != tabs.m:
            raise ValueError("one scalar vector per staged query")
        cols = []
        for s in scalars_list:
            s = self.witness_limbs_dev(s)
            if s.shape[1] > n:
                raise ValueError("more scalars than points")
            cols.append(torch.nn.functional.pad(s, (0, n - s.shape[1])))
        return torch.stack(cols, dim=1)                  # (16, M, n)

    def _msm_many(self, points, scalars_list, is_g2: bool) -> list:
        if isinstance(points, MT.AffineTables):
            out = CT.msm_tree(points, self._scalars(points, scalars_list))
        else:
            if not isinstance(points, MD.DenseTables):
                stage = (self.stage_g2_stacked if is_g2
                         else self.stage_g1_stacked)
                points = stage(points)
            out = MD.msm_dense(points, self._scalars(points, scalars_list))
        if is_g2:
            return ec.g2_points_from_device(*out)
        return ec.g1_points_from_device(*out)

    def msm_g1_many(self, points, scalars_list) -> list:
        """M G1 MSMs, one scalar vector each, over staged tree tables
        (AffineTables), staged dense multiples (DenseTables), or M host
        point lists or raw queries (staged here, then dense)."""
        return self._msm_many(points, scalars_list, False)

    def msm_g2_many(self, points, scalars_list) -> list:
        return self._msm_many(points, scalars_list, True)

    def msm_g1(self, points, scalars):
        return self.msm_g1_many([points], [scalars])[0]

    def msm_g2(self, points, scalars):
        return self.msm_g2_many([points], [scalars])[0]


def _pad_cols(a: np.ndarray, total: int, fill_y0: bool = False):
    out = np.zeros((F.NLIMBS, total), np.uint32)
    out[:, :a.shape[1]] = a
    if fill_y0:
        out[0, a.shape[1]:] = 1
    return out


def _g1_coords(q, total: int):
    """Query (point list or raw query) -> (x, y, z) (16, total) plain
    limbs, padded with the identity (0 : 1 : 0)."""
    if hasattr(q, "x"):
        x, y, z = q.x, q.y, q.z
    else:
        x, y, z = ec.g1_limb_coords(list(q))
    return (_pad_cols(x, total), _pad_cols(y, total, True),
            _pad_cols(z, total))


def _g2_coords(q, total: int):
    """-> (x0, x1, y0, y1, z0, z1) (16, total) plain limbs."""
    if hasattr(q, "x0"):
        arrs = (q.x0, q.x1, q.y0, q.y1, q.z0,
                np.zeros_like(q.z0))
    else:
        arrs = ec.g2_limb_coords(list(q))
    return tuple(_pad_cols(a, total, i == 2) for i, a in enumerate(arrs))
