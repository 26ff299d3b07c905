"""Process-group bring-up for the distributed prover, and a launcher.

The collectives of ``parallel/`` (helpers of ``mesh.py``) work over
whatever process group a ``Mesh`` holds.  What a multi-card or multi-host
run needs on top is process bring-up, the reference's MPI/NCCL bootstrap
role; in PyTorch that is ``torch.distributed.init_process_group``, one
process (rank) per device: NCCL between cards, gloo on the CPU or when
ranks share a card.  This module wraps exactly that:

* ``initialize(...)``: idempotent process-group bring-up, parameters from
  the arguments or the standard environment (MASTER_ADDR / MASTER_PORT /
  WORLD_SIZE / RANK, as torchrun sets them); a 1-process world with nothing
  configured is a no-op, so the same prover script runs unchanged on one
  card or many.
* ``global_mesh(...)``: a Mesh over every rank (``mesh.make_mesh``).
* ``all_processes_equal(...)``: a transcript-divergence tripwire.
* ``spawn_world(...)``: run one function on a fresh world of processes
  (start method ``spawn``: CUDA cannot fork), return every rank's result,
  and raise if any rank raises.

The JAX package's other host-to-mesh helpers need no function here: a
sharded value is the rank's local block, so its ``host_local_to_global``
is ``GF.from_u64(block, mesh.device)``, and its ``replicated_from_host``
is ``mesh.broadcast`` from rank 0.

Transcript discipline: the host-side Challenger runs on every rank, and
only ever consumes Merkle caps and opening values that are replicated
outputs of the sharded steps, so all ranks derive identical challenges
with no extra communication.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh, make_mesh, pmax

DEFAULT_TIMEOUT_S = 900


def _own_card_each(world_size: int) -> bool:
    """True when every rank of this host can have a card of its own."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return torch.cuda.is_available() and torch.cuda.device_count() >= local


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the process group (idempotent).

    With world_size 1 (or nothing configured) this is a no-op.  backend:
    None picks NCCL when each rank has a card of its own, else gloo; under
    NCCL the rank's card (LOCAL_RANK, else RANK) becomes its current
    device.
    """
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    if world_size <= 1 or init_method is None:
        return
    if backend is None:
        backend = "nccl" if _own_card_each(world_size) else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


global_mesh = make_mesh


def all_processes_equal(value_np, mesh: Mesh | None = None) -> bool:
    """True when every rank passed the same value: one all_reduce (max) of
    the value's hash and of its negation (a debug aid; the transcript is
    replicated by construction, this checks a deployment has not broken
    that)."""
    mesh = mesh if mesh is not None else make_mesh()
    raw = value_np if isinstance(value_np, bytes) else \
        np.ascontiguousarray(value_np).tobytes()
    h = int.from_bytes(hashlib.blake2b(raw, digest_size=7).digest(), "little")
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    both = pmax(torch.tensor([h, -h], dtype=torch.int64, device=dev), mesh)
    return int(both[0]) == h and int(both[1]) == -h


# -- launcher -------------------------------------------------------------------

def _rank_main(rank: int, fn, world_size: int, backend: str, devices: list,
               init_method: str, out_dir: str, timeout_s: float,
               args: tuple) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        try:
            result = fn(make_mesh(device), *args)
        except BaseException:
            with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
            raise
        tmp = os.path.join(out_dir, f"rank{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def _join(ctx, out_dir: str) -> bool:
    """ctx.join(1 s); on a failed rank (after the others were stopped)
    raise with the traceback of every rank that recorded one."""
    try:
        return ctx.join(timeout=1)
    except Exception as exc:
        errs = sorted(f for f in os.listdir(out_dir) if f.endswith(".err"))
        texts = []
        for f in errs:
            with open(os.path.join(out_dir, f)) as fh:
                texts.append(f"{f[:-4]}:\n{fh.read()}")
        raise RuntimeError("spawn_world: a rank failed\n"
                           + "\n".join(texts)) from exc


def spawn_world(fn, world_size: int, backend: str | None = None,
                device_of_rank=None, args: tuple = (),
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(mesh, *args) on a fresh world of world_size processes and
    return every rank's result, in rank order.

    fn must be importable by name (a module-level function).  backend:
    None picks NCCL when each rank has a card of its own, else gloo.
    device_of_rank(rank) -> device; None gives rank r the card r mod the
    card count (CUDA is required).  A rank that raises, or a world that
    outlives timeout_s, makes this raise after every rank has stopped.
    """
    if device_of_rank is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device_of_rank "
                               "to run the ranks on the CPU")
        count = torch.cuda.device_count()
        devices = [f"cuda:{r % count}" for r in range(world_size)]
    else:
        devices = [str(torch.device(device_of_rank(r)))
                   for r in range(world_size)]
    if backend is None:
        own = all(d.startswith("cuda") for d in devices) and \
            len(set(devices)) == world_size
        backend = "nccl" if own else "gloo"
    out_dir = tempfile.mkdtemp(prefix="spawn_world_")
    # a file rendezvous in the world's own directory: no port to race for
    init_method = "file://" + os.path.join(out_dir, "rendezvous")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, devices, init_method,
                              out_dir, timeout_s, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not _join(ctx, out_dir):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"spawn_world: ranks still running after "
                                   f"{timeout_s} s")
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
