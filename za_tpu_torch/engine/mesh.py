"""Several cards: the prove sharded over the ranks of a torch.distributed
process group (the reference's za_tpu/engine/mesh.py, a 1-D device mesh
under shard_map).

One process a rank; every rank holds the same host data and runs the
same kernels as one card on its shard (``engine.dist``):

  * the R1CS matvec by row block: rank d owns domain rows [d m/D,
    (d + 1) m/D) of the three legs, A's input-preservation rows with
    whichever rank owns them (``shard_csr``); the legs are contiguous
    domain shards (8, 3, m/D);
  * the four-step NTT (``transform``) on contiguous natural-order
    shards, D^2 | m: each sub-NTT's lane columns split over the ranks,
    an ``all_to_all`` where one card transposes or reorders, the prefix
    (every mode), tail and twiddle kernels on this rank's slices of the
    tables (``ShardedDomain``);
  * the MSMs (``tree_msm``, ``dense_msm``): each rank sums its chunks
    (tree: C/D chunks of the staged tables) or its n/D points (dense)
    into per-window projective sums, which one ``all_gather`` brings to
    every rank; log2 D fold-half ``ec_add`` launches reduce the D copies
    (complete adds: the tree's affine adds are incomplete) and Horner
    runs on every rank, which so ends with the same points.

``Mesh`` wraps the group and the three collectives the path needs, each
counted with its bytes and seconds in ``Mesh.stats``.
"""

from __future__ import annotations

import functools
import os
import time

import torch

from . import cuda_tree as CT, ec, field as F, msm as MSM, msm_dense as MD
from . import ntt as NTT, r1cs as RC
from .dist import default_backend, need_cards
from . import metrics as MET


class Mesh:
    """A 1-D mesh of ``size`` ranks over a torch.distributed group (None:
    the default group).  Over NCCL the collectives move device tensors
    between cards; over gloo (the CPU, or ranks that share a card) they
    copy to the host, run there, and copy back to the tensor's device.
    ``stats``: per collective [calls, bytes this rank sent, seconds of
    host wall]; with ``timed`` on, a CUDA tensor's device is synchronised
    before and after each call, so the seconds hold the device's work."""

    def __init__(self, size: int, rank: int, backend: str, group=None):
        self.size = size
        self.rank = rank
        self.backend = backend
        self.group = group
        self.stats: dict[str, list] = {}
        self.timed = False

    def _run(self, name: str, t: torch.Tensor, fn) -> torch.Tensor:
        sync = self.timed and t.is_cuda
        if sync:
            MET.synchronize(t.device)
        t0 = time.perf_counter()
        src = t.contiguous()
        if self.backend != "nccl" and src.is_cuda:   # gloo: via the host
            src = MET.to_host(src)
            out = MET.to_device(fn(src), t.device)
        else:
            out = fn(src)
        if sync:
            MET.synchronize(t.device)
        st = self.stats.setdefault(name, [0, 0, 0.0])
        st[0] += 1
        st[1] += src.numel() * src.element_size()
        st[2] += time.perf_counter() - t0
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t -> (D, *t.shape), rank d's at [d]."""
        def fn(src):
            out = [torch.empty_like(src) for _ in range(self.size)]
            torch.distributed.all_gather(out, src, group=self.group)
            return torch.stack(out)
        return self._run("all_gather", t, fn)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t (D, ...): t[e] goes to rank e; -> (D, ...), [d] from rank d."""
        def fn(src):
            out = torch.empty_like(src)
            torch.distributed.all_to_all_single(out, src, group=self.group)
            return out
        return self._run("all_to_all", t, fn)

    def all_true(self, flag) -> bool:
        """Whether flag holds on every rank: one all_reduce (min) of one
        int, so that every rank takes the same branch."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        if self.backend == "nccl":
            t = MET.to_device(t, torch.device("cuda",
                                              torch.cuda.current_device()))

        def fn(src):
            torch.distributed.all_reduce(src, torch.distributed.ReduceOp.MIN,
                                         group=self.group)
            return src
        out = self._run("all_reduce", t, fn)
        return MET.host_bool(out) if out.is_cuda else bool(out)

    def broadcast(self, values: list) -> list:
        """Rank 0's values (picklable) on every rank."""
        out = list(values)
        torch.distributed.broadcast_object_list(out, src=0, group=self.group)
        return out


def make_mesh(n: int, backend: str | None = None) -> Mesh:
    """The mesh of the n ranks of this process's group, with this rank's
    place in it.  backend: the group's where one is joined (gloo on CUDA
    tensors puts ranks that share a card on one mesh), else nccl on a card
    and gloo on the CPU; another than the group's makes a group of its
    own.  Refuses, as the reference does, a size that is no power of two
    and too few devices: NCCL runs one rank a card and never falls back
    to gloo; a group of another size than n is refused too.  Without a
    group, a mesh of one rank joins a group of one (an in-process store)."""
    dist = torch.distributed
    if n < 1 or n & (n - 1):
        raise RuntimeError(f"mesh size must be a power of two, got {n}")
    joined = dist.is_initialized()
    if backend is None:
        backend = dist.get_backend() if joined else default_backend()
    if backend == "nccl":
        need_cards(int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if not joined:
        if n > 1:
            raise RuntimeError(
                f"mesh needs {n} ranks, this process is in no group "
                f"(start the ranks with ZA_DIST, torchrun or za --mesh "
                f"{n}; engine.dist.init_distributed)")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"mesh needs {n} ranks, the group has {world}")
    group = None if backend == dist.get_backend() else dist.new_group(
        backend=backend)
    return Mesh(n, dist.get_rank(), backend, group)


# -- the R1CS matvec by row block ------------------------------------------------


def shard_csr(r1cs, m: int, mesh: Mesh, device) -> RC.Csr:
    """This rank's rows [d m/D, (d + 1) m/D) of the A (with the
    input-preservation rows n .. n + ni - 1), B and C legs at domain size
    m, as one CSR of m/D rows a leg; cached on the r1cs per device, m and
    mesh layout."""
    cache = r1cs.__dict__.setdefault("_torch_csr", {})
    key = (str(device), m, mesh.size, mesh.rank)
    if key not in cache:
        m_loc = m // mesh.size
        lo = mesh.rank * m_loc
        a = list(r1cs.a_rows) + [[(i, 1)] for i in range(r1cs.num_inputs)]
        cache[key] = RC.pack_csr(
            tuple(rows[lo:lo + m_loc] for rows in (a, r1cs.b_rows,
                                                   r1cs.c_rows)),
            m_loc, device)
    return cache[key]


# -- the four-step NTT over the ranks ----------------------------------------------


class ShardedDomain:
    """A 2^k domain's four-step tables (``ntt.FourStepTables``: values
    viewed as (n2, n1), a sub-NTT of length n2 over n1 lane columns, the
    twiddle transpose, a sub-NTT of length n1 over n2 lanes) for this
    rank's lanes: q1 = n1/D of the first sub-NTT's and q2 = n2/D of the
    second's.  The sub-NTT twiddles are whole; ``inter`` (8, n2, q1) and
    the h(x) tables are this rank's columns, contiguous: ``coset_pow``
    (8, n2 q1), the first sub-NTT's load table at [j2, j1 - d q1], and
    ``h_out`` (8, n1 q2), the last one's store table at [k1, k2 - d q2]."""

    def __init__(self, size: int, mesh: Mesh, device):
        D, d = mesh.size, mesh.rank
        if size % (D * D):
            raise ValueError("four-step layout needs D^2 | n")
        full = NTT.DeviceDomain(size, device)
        fs = full.fourstep
        self.size, self.D = size, D
        self.n1, self.n2 = n1, n2 = fs.n1, fs.n2
        self.q1, self.q2 = q1, q2 = n1 // D, n2 // D
        lanes = slice(d * q1, (d + 1) * q1)
        self.tables = {
            inv: (t2, t1, inter[:, :, lanes].contiguous())
            for inv, (t2, t1, inter) in ((False, fs.tables(False)),
                                         (True, fs.tables(True)))}
        self.coset_pow = full.coset_pow.view(F.NL32, n2, n1)[
            :, :, lanes].reshape(F.NL32, n2 * q1).contiguous()
        self.h_out = full.h_out.view(F.NL32, n1, n2)[
            :, :, d * q2:(d + 1) * q2].reshape(F.NL32, n1 * q2).contiguous()


def _exchange(mesh: Mesh, x: torch.Tensor, split: int,
              gather: int) -> torch.Tensor:
    """One all_to_all: axis `split` of x cut into D blocks, block e to
    rank e; the blocks received, from ranks 0 .. D - 1, put together in
    rank order along axis `gather` (of x with the block's length on
    `split`)."""
    D = mesh.size
    shape = list(x.shape)
    parts = x.reshape(shape[:split] + [D, shape[split] // D]
                      + shape[split + 1:]).movedim(split, 0)
    got = mesh.all_to_all(parts)                 # (D, ..., q on split, ...)
    got = got.movedim(0, gather)
    shape = list(got.shape)
    return got.reshape(shape[:gather] + [D * shape[gather + 1]]
                       + shape[gather + 2:])


def transform(mesh: Mesh, sd: ShardedDomain, x: torch.Tensor, inverse: bool,
              scale_in=None, combine: bool = False,
              scale_out=None) -> torch.Tensor:
    """``ntt.transform`` on contiguous natural-order shards: l32 (8, B,
    n/D) -> (8, B', n/D), or (16, B', n/D) plain limbs with scale_out;
    the modes' tables are the ShardedDomain's slices (scale_in: its
    coset_pow, scale_out: its h_out).  Three all_to_alls: rows to lane
    columns before the first sub-NTT, lane columns to rows between the
    two, and back to natural order after the second."""
    t2, t1, inter = sd.tables[inverse]
    n1, n2, q1, q2 = sd.n1, sd.n2, sd.q1, sd.q2
    B = x.shape[1]
    # rows j2 of this rank, all j1 -> all j2, this rank's j1 (lanes)
    a = _exchange(mesh, x.reshape(F.NL32, B, q2, n1), 3, 2)  # (8, B, n2, q1)
    a = NTT.sub_ntt(a, t2, n2, scale_in, combine)
    a = NTT.ntt_twiddle(a, inter)                     # (8, B', q1, n2)
    b = _exchange(mesh, a, 3, 2)                      # (8, B', n1, q2)
    b = NTT.sub_ntt(b, t1, n1, scale_out=scale_out)   # (E, B', n1, q2)
    c = _exchange(mesh, b, 2, 3)                      # (E, B', q1, n2)
    return c.reshape(c.shape[0], c.shape[1], q1 * n2)


def h_transforms(mesh: Mesh, sd: ShardedDomain,
                 legs: torch.Tensor) -> torch.Tensor:
    """``ntt.h_transforms`` on this rank's shard of the legs, l32 (8, 3,
    m/D) -> (16, m/D) int32 plain limbs of h's coefficients
    [d m/D, (d + 1) m/D); the same stages (``ntt.h_stages``)."""
    h = NTT.h_stages(functools.partial(transform, mesh, sd), legs,
                     sd.coset_pow, sd.h_out)
    return h.reshape(F.NLIMBS, sd.size // sd.D)


# -- the MSMs --------------------------------------------------------------------


def reduce_horner(mesh: Mesh, wsum, is_g2: bool, bits: int):
    """This rank's per-window projective sums, leaves (*E, M, W) -> the
    MSMs over every rank, leaves (*E, M), on every rank: one all_gather
    a coordinate, log2 D fold-half ec_add launches (rank d + D/2 into
    rank d), Horner (the reference's _gather_reduce_horner)."""
    ne = ec.elem_axes(is_g2)
    p = tuple(mesh.all_gather(c).movedim(0, ne) for c in wsum)
    n = mesh.size
    while n > 1:
        n //= 2
        p = ec.ec_add(tuple(c.narrow(ne, 0, n) for c in p),
                      tuple(c.narrow(ne, n, n) for c in p), is_g2)
    return MSM.horner_windows(tuple(c.select(ne, 0) for c in p), is_g2,
                              bits)


def tree_msm(mesh: Mesh, tables, scalars):
    """M MSMs over this rank's C/D chunks of the staged affine tables
    (the reference's sharded_tree_msm_fn): scalars (16, M, C S / D), the
    rank's columns -> projective leaves (*E, M) of the whole MSMs."""
    return reduce_horner(mesh, CT.tree_window_sums(tables, scalars),
                         tables.is_g2, 4)


def dense_msm(mesh: Mesh, tabs: MD.DenseTables, scalars):
    """M MSMs over this rank's n/D points of staged dense multiples
    (the reference's sharded_dense_pallas_msm_fn): the window sums with
    the lanes planned for the local n, the lane fold, then as tree_msm."""
    acc = MD.dense_window_sums(tabs, MD.digits(scalars, tabs.radix),
                               *MD.plan(tabs))
    return reduce_horner(mesh, MSM.lane_fold(acc, tabs.is_g2), tabs.is_g2,
                         MD.BITS[tabs.radix])
