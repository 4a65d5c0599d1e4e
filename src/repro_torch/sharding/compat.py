"""Process groups, device meshes and rank launching.

The port of the reference's ``sharding/compat.py``. The reference runs
one controller over every device of a host (``jax.make_mesh``); the port
runs one process per device, joined by ``torch.distributed`` (NCCL on
the cards, ``gloo`` on the CPU), with the rendezvous given explicitly:

  * :func:`init_distributed` joins a process group at a given address,
    rank and world size (``file://`` under a test's temporary directory,
    ``tcp://127.0.0.1:<port>`` on the card);
  * :func:`spawn` starts ``world_size`` ranks of a function in fresh
    processes, returns each rank's result, and raises on any rank's
    failure or on its timeout, having killed every rank: a collective
    that hangs never hangs the caller;
  * :func:`make_mesh` is a ``DeviceMesh`` over the joined group
    (``init_device_mesh``), :func:`make_mesh_1d` the list of the first
    ``n`` local devices that a sweep splits its points over (no process
    group: one host thread drives every device);
  * :func:`activate_mesh` does nothing: DTensors carry their mesh, so
    there is no ambient mesh to install. It is kept for the reference's
    call sites.

The reference's ``shard_map`` (a function mapped over mesh shards) has
no counterpart: each rank runs its own shard's code, and the collectives
are explicit (``torch.distributed``) or DTensor redistributions.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def free_tcp_address() -> str:
    """``tcp://127.0.0.1:<port>`` with a port that was free just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def init_distributed(backend: str, *, rank: int, world_size: int,
                     init_method: str, timeout: float = 300.0) -> None:
    """Join the default process group. ``backend`` is ``"nccl"`` (rank r
    on ``cuda:r``, which it makes the current device) or ``"gloo"``;
    ``timeout`` (seconds) bounds the rendezvous and every collective."""
    if backend == "nccl":
        if rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} of {world_size}: NCCL needs a card per rank "
                f"and this host has {torch.cuda.device_count()}")
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))


def rank_device(backend: str) -> torch.device:
    """This rank's device: its card under NCCL, else the CPU."""
    if backend == "nccl":
        return torch.device("cuda", dist.get_rank())
    return torch.device("cpu")


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    default process group (which must hold their product of ranks);
    ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = 1
    for s in axis_shapes:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {tuple(axis_shapes)} mesh needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def make_mesh_1d(n_devices: int, axis_name: str = "points"
                 ) -> List[torch.device]:
    """The first ``n_devices`` local devices (the cards, or the CPU once
    when there is none) that a sweep splits its points over; the name is
    the reference's and names nothing here."""
    del axis_name
    if torch.cuda.is_available():
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = [torch.device("cpu")]
    return avail[:max(1, n_devices)]


def activate_mesh(mesh):
    """No ambient mesh in PyTorch: a context that does nothing."""
    del mesh
    return contextlib.nullcontext()


def _rank_main(fn, rank, world_size, backend, init_method, timeout, args,
               results):
    """One rank: join the group, run ``fn(*args)``, send its result (or
    the traceback) to the parent, and leave the group either way."""
    torch.set_num_threads(1)
    try:
        init_distributed(backend, rank=rank, world_size=world_size,
                         init_method=init_method, timeout=timeout)
        # by value: the queue's own pickler would pass tensors as shared
        # memory handles that die with this process
        out = pickle.dumps(fn(*args))
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world_size: int, *, backend: str = "gloo",
          timeout_s: float = 300.0, init_method: Optional[str] = None,
          args: tuple = ()) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a fresh process
    (the ``spawn`` start method) joined to one ``backend`` group, and
    return their results in rank order. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function); each rank sees the group and its
    rank through ``torch.distributed``. ``init_method`` defaults to a free
    local TCP port.

    Raises ``RuntimeError`` with the failing rank's traceback when a rank
    raises or exits nonzero, and ``TimeoutError`` when the ranks have not
    all finished ``timeout_s`` seconds after the start; every rank still
    running is killed first. Under NCCL, ``world_size`` may not exceed
    the cards (two ranks on one card is refused by NCCL)."""
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} NCCL ranks need {world_size} cards; "
                         f"this host has {torch.cuda.device_count()}")
    init_method = init_method or free_tcp_address()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, init_method,
                               timeout_s, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, failed = {}, None
    try:
        while len(got) < world_size and failed is None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size} ranks of {fn.__name__} not done after "
                    f"{timeout_s:.0f} s (finished: {sorted(got)})")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    failed = (dead[0], f"exit code {procs[dead[0]].exitcode}"
                              " with no result")
                continue
            if ok:
                got[rank] = pickle.loads(out)
            else:
                failed = (rank, out)
        if failed is not None:
            raise RuntimeError(f"rank {failed[0]} of {world_size} failed in "
                               f"{fn.__name__}:\n{failed[1]}")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited nonzero: {bad}")
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
        results.join_thread()
