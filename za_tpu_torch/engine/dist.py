"""Several processes, one rank each: the torch.distributed process group
and the host side of sharding (the reference's za_tpu/engine/dist.py).

Every rank runs the same program on the same host data (pk, R1CS,
witness) and uploads only its shard of what is sharded (``shard_of``,
the reference's host_to_global); collectives run over the group that
``engine.mesh.make_mesh`` wraps.  A process joins a group when

  * ``ZA_DIST="host:port,nprocs,procid"`` is set (the reference's
    format and error text), or
  * torchrun's variables are (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``: the counterparts of the
    reference's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``),

and calls ``init_distributed()`` before it builds an engine.  The
backend is NCCL on a card (the rank's card is ``LOCAL_RANK``, else its
rank modulo the host's cards) and gloo on the CPU.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch

#: torchrun's default MASTER_PORT
DEFAULT_PORT = 29500


def dist_spec(env=None) -> tuple[str, int, int] | None:
    """(coordinator "host:port", world size, rank) from ZA_DIST or
    torchrun's variables; None when neither is set."""
    env = os.environ if env is None else env
    spec = env.get("ZA_DIST", "")
    if spec:
        try:
            coordinator, nproc_s, pid_s = spec.split(",")
            return coordinator, int(nproc_s), int(pid_s)
        except ValueError as exc:
            raise ValueError(
                f"ZA_DIST must be 'host:port,nprocs,procid', got {spec!r}"
            ) from exc
    if "MASTER_ADDR" in env:
        port = env.get("MASTER_PORT", str(DEFAULT_PORT))
        return (f"{env['MASTER_ADDR']}:{port}",
                int(env.get("WORLD_SIZE", "1")), int(env.get("RANK", "0")))
    return None


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def need_cards(n: int) -> None:
    """NCCL runs one rank a card: refuses n ranks on this host's cards."""
    cards = torch.cuda.device_count()
    if n > cards:
        raise RuntimeError(
            f"mesh needs {n} devices, have {cards}: nccl runs one rank a "
            f"card (ranks that share a card: engine.mesh.make_mesh(n, "
            f"backend='gloo'))")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join the process group given by the arguments, ZA_DIST or
    torchrun's variables, over default_backend().  True when this
    process is one rank of a group of several (a group already joined
    counts), False for a single process (nothing done)."""
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None:
        spec = dist_spec()
        if spec is not None:
            coordinator, num_processes, process_id = spec
    if coordinator is None or (num_processes or 1) <= 1:
        return False
    backend = default_backend()
    if backend == "nccl":
        local = int(os.environ.get(
            "LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        need_cards(local + 1)
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def free_port() -> int:
    """A TCP port of this host that no socket holds now (the kernel's
    pick for port 0), for a group's coordinator on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_of(arr, axis: int, rank: int, size: int):
    """This rank's contiguous block of a replicated host array or tensor
    along axis: [rank n/size, (rank + 1) n/size), n a multiple of size."""
    n = arr.shape[axis]
    if n % size:
        raise ValueError(f"shard_of: {n} entries on axis {axis} do not "
                         f"split over {size} ranks")
    k = n // size
    index = [slice(None)] * arr.ndim
    index[axis] = slice(rank * k, (rank + 1) * k)
    return arr[tuple(index)]


def fetch_replicated(t) -> np.ndarray:
    """A replicated device result (every rank holds the same values) ->
    a host numpy copy on this rank."""
    return t.detach().cpu().numpy()
