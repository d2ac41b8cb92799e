"""The collectives of the port's sharded engines, on ``torch.distributed``
(the port's counterpart of the JAX package's ``shard_map``, ``psum`` and
``ppermute``).

The JAX package runs one controller over a device mesh. The port runs one
process per shard rank (SPMD): each rank builds its own solver on its own
device and its own part of the data, calls the same code, and exchanges
tensors through the default process group. State that the JAX modules
replicate is computed alike on every rank.

- :func:`init_group` joins a rank to the group. The backend follows the
  device list: ``nccl`` when every rank has a card of its own, ``gloo``
  when ranks share a card or run on the CPU. The choice is made once and
  logged; a failed NCCL start raises (there is no fallback to gloo).
  Ranks meet at a file (``FileStore``), not at a TCP port.
- :func:`psum`, :func:`merge_owned`, :func:`reduce_min`,
  :func:`all_gather` and :func:`exchange_halo` are the collectives. Gloo
  takes CUDA tensors for ``all_reduce`` and ``broadcast`` only; its other
  collectives here copy a CUDA tensor through pinned host memory, which is
  then the transport.
- :func:`launch` spawns one process per device, runs a function in each
  and returns every rank's result; a rank's error raises with its
  traceback, and a rank that hangs in a collective times the call out.
"""
from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)

#: The rank's group: rank, world size, device, backend.
_GROUP: dict = {}

#: This process's collectives so far: calls, bytes sent (a rank's
#: tensor, each call) and wall seconds in them (a gloo call on a CUDA
#: tensor waits for the card's queued work first).
traffic = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _count(nbytes: int, t0: float) -> None:
    traffic["calls"] += 1
    traffic["bytes"] += int(nbytes)
    traffic["seconds"] += time.perf_counter() - t0


def _devices(devices: Sequence) -> List[torch.device]:
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        out.append(d)
    return out


def choose_backend(devices: Sequence) -> str:
    """"nccl" when every rank has a card of its own, else "gloo" (ranks
    that share a card, or ranks on the CPU)."""
    devs = _devices(devices)
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def init_group(rank: int, devices: Sequence, init_file: str,
               timeout_s: float = 600.0) -> torch.device:
    """Joins rank ``rank`` of ``len(devices)`` to the default process group
    (rendezvous at the file ``init_file``, which the ranks share and no
    earlier group used) on ``devices[rank]``, which it returns. A
    collective that waits longer than ``timeout_s`` raises."""
    devs = _devices(devices)
    backend = choose_backend(devs)
    device = devs[rank]
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("every rank has a card of its own, so the group "
                           "needs nccl, which this torch lacks")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=len(devs), timeout=datetime.timedelta(seconds=timeout_s),
        **extra)
    _GROUP.update(rank=rank, world=len(devs), device=device,
                  backend=backend)
    _log.info("rank %d of %d on %s: backend %s", rank, len(devs), device,
              backend)
    return device


def rank() -> int:
    return dist.get_rank()


def world() -> int:
    return dist.get_world_size()


def backend() -> str:
    """The group's backend, as :func:`init_group` chose it."""
    return _GROUP["backend"]


def _through_host(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` (``all_reduce`` with SUM), a new
    tensor."""
    t0 = time.perf_counter()
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    _count(out.numel() * out.element_size(), t0)
    return out


def merge_owned(x: torch.Tensor) -> torch.Tensor:
    """Every rank's float32 ``x`` merged, where each element is non-zero on
    one rank at most (its owner): the SUM of the bit patterns as int32, so
    the owner's bits come back exactly, signed zeros and NaNs included."""
    if x.dtype != torch.float32:
        raise TypeError(f"merge_owned: float32, not {x.dtype}")
    return psum(x.contiguous().view(torch.int32)).view(torch.float32)


def reduce_min(value: float) -> float:
    """The least of every rank's ``value``."""
    t0 = time.perf_counter()
    t = torch.tensor([value], dtype=torch.float64, device=_GROUP["device"])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    out = float(t.item())
    _count(8, t0)
    return out


def all_gather(x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``x`` (the same shape on each), in rank order, on
    ``x``'s device."""
    t0 = time.perf_counter()
    if not _through_host(x):
        out = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(out, x.contiguous())
    else:
        host = x.to("cpu").pin_memory()
        out = [torch.empty_like(host) for _ in range(world())]
        dist.all_gather(out, host)
        out = [t.to(x.device, non_blocking=True) for t in out]
    _count(x.numel() * x.element_size(), t0)
    return out


def exchange_halo(block: torch.Tensor, radius: int) -> torch.Tensor:
    """``block`` ([Hs, ...], this rank's rows of an array split along its
    first axis in rank order) with ``radius`` rows of each neighbour rank
    before and after it, zero at the global border (the JAX package's
    ``spatial._exchange_halo``). Every block has at least ``radius``
    rows."""
    if block.shape[0] < radius:
        raise ValueError(f"exchange_halo: {block.shape[0]} rows, radius "
                         f"{radius}")
    t0 = time.perf_counter()
    r, n = rank(), world()
    host = _through_host(block)

    def buf(x):
        x = x.contiguous()
        return x.to("cpu").pin_memory() if host else x

    top, bottom = buf(block[:radius]), buf(block[block.shape[0] - radius:])
    above, below = torch.zeros_like(top), torch.zeros_like(bottom)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, top, r - 1),
                dist.P2POp(dist.irecv, above, r - 1)]
    if r + 1 < n:
        ops += [dist.P2POp(dist.isend, bottom, r + 1),
                dist.P2POp(dist.irecv, below, r + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if host:
        above = above.to(block.device, non_blocking=True)
        below = below.to(block.device, non_blocking=True)
    _count(2 * top.numel() * top.element_size(), t0)
    return torch.cat([above, block, below], dim=0)


# ----------------------------------------------------------------- launch --

def to_host(obj):
    """``obj`` with every tensor as a numpy array (results cross the
    process boundary by pickle)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank_: int, devices, init_file: str, timeout_s: float,
               threads: int, args, results) -> None:
    try:
        torch.set_num_threads(threads)
        device = init_group(rank_, devices, init_file, timeout_s)
        out = to_host(fn(rank_, device, *args))
        results.put(("result", rank_, out))
    except BaseException:
        results.put(("error", rank_, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence, *args,
           timeout_s: float = 600.0) -> list:
    """Runs ``fn(rank, device, *args)`` in one spawned process per entry of
    ``devices`` (rank i on ``devices[i]``), each joined to one process
    group (:func:`init_group`), and returns every rank's result in rank
    order, tensors as numpy arrays. ``fn`` must be importable at module
    level, and its arguments and result picklable.

    Raises with the rank's traceback if a rank fails; raises
    ``TimeoutError`` if the ranks are not all done after ``timeout_s``
    seconds (a rank waiting in a collective on a dead one), and stops
    every rank either way. A rank takes this process's CPU threads over
    the ranks."""
    n = len(devices)
    threads = max(1, torch.get_num_threads() // n)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lexp_group_")
    init_file = os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}", daemon=True,
                         args=(fn, r, [str(d) for d in devices], init_file,
                               timeout_s, threads, args, results))
             for r in range(n)]
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(n)) - set(out))
                raise TimeoutError(f"launch: ranks {missing} not done after "
                                   f"{timeout_s} s")
            try:
                kind, r, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in out and p.exitcode is not None]
                if dead and results.empty():
                    raise RuntimeError(
                        f"launch: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result") from None
                continue
            if kind == "error":
                raise RuntimeError(f"launch: rank {r} failed:\n{value}")
            out[r] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n)]


def row_block(x, rank_: int, world_: int):
    """Rank ``rank_``'s rows of ``x`` split along its first axis in
    ``world_`` blocks of ``ceil(len / world_)`` rows (the last shorter)."""
    hq = -(-int(x.shape[0]) // world_)
    return x[rank_ * hq:(rank_ + 1) * hq]
