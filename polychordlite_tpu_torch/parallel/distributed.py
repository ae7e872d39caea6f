"""Several processes over ``torch.distributed`` (counterpart of
``polychordlite_tpu/parallel/distributed.py``).

The reference scales across nodes with ``mpirun`` (every rank runs the same
binary; SURVEY §5.8).  Here every process runs the same program, joined in
one process group: under ``torchrun`` its environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), or the
address, the count and the index given to :func:`initialise_distributed`.
The chain batch is split over the shards of all processes
(``parallel/mesh.py``); the epoch needs nothing from another shard, and the
nurseries are gathered back on the host.

The backend is gloo: everything that crosses processes is a host array (the
packed nursery, the clock seed, the timed speeds, the flags), and two ranks
may share one card (NCCL refuses that).  Host administration runs the same
on every process (same seeds, same numpy state); only process 0 writes
files.  In one process every function here is the identity, and nothing
falls back to one process: a process group asked for that does not start
raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def process_count() -> int:
    """The processes of the run (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index on its host: torchrun's ``LOCAL_RANK``, else
    its rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def initialise_distributed(coordinator_address=None, num_processes=None, process_id=None) -> int:
    """Join the process group if one is asked for, and return this
    process's rank (0 in one process).

    Asked for by ``num_processes`` > 1 (with ``coordinator_address``
    ``"host:port"`` and ``process_id``), or by torchrun's environment
    (``WORLD_SIZE`` > 1).  A group already started is kept.  A group that
    does not start raises; the run never goes on as one process."""
    if dist.is_initialized():
        return dist.get_rank()
    if num_processes is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("gloo", init_method="env://")
        return dist.get_rank()
    if num_processes is not None and int(num_processes) > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator_address and process_id")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
        return dist.get_rank()
    return 0


def is_root() -> bool:
    """True on the process that owns file output (rank 0 in the reference)."""
    return process_index() == 0


def broadcast_from_root(arr):
    """Adopt process 0's value on every process (reference: MPI_BCAST of
    root-decided quantities — the RNG seed, ``random_utils.F90:26-109``, and
    the timed per-grade speeds, ``generate.F90:303-309``).  Wall-clock values
    differ per process; the same administration on every process needs
    root's."""
    if process_count() == 1:
        return arr
    a = np.asarray(arr)
    t = torch.from_numpy(np.array(a).reshape(-1))
    dist.broadcast(t, src=0)
    return t.numpy().reshape(a.shape)


def all_any_flags(flag: bool):
    """(all_true, any_true) of a per-process boolean, agreed by every
    process.  Turns a mismatch between processes (a resume file that some
    see and others do not) into the same error on every process instead of
    a hang in the next collective."""
    if process_count() == 1:
        return bool(flag), bool(flag)
    flags = all_gather_rows(np.asarray([int(bool(flag))], np.int64))
    return bool(flags.min()), bool(flags.max())


def all_gather_rows(local: np.ndarray) -> np.ndarray:
    """Every process's ``local`` array (the same shape and dtype on each),
    stacked along the first axis in rank order."""
    if process_count() == 1:
        return local
    t = torch.from_numpy(np.array(local))
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts).numpy()
