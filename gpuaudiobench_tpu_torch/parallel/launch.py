"""Run one program on every rank of a process group: the SPMD launcher.

``spmd(fn, world, device, *args, timeout_s=...)`` starts ``world``
processes with ``torch.multiprocessing`` (start method "spawn"), joins
them into one process group and calls ``fn(*args)`` on each; it returns
what rank 0's call returned.

* The ranks meet through a ``FileStore`` in a fresh temporary directory:
  no network port.
* ``device="cuda"``: NCCL, rank r on ``cuda:r``. ``device="cpu"``: gloo,
  each rank on one thread. Neither switches to the other.
* ``timeout_s`` bounds every collective (``init_process_group``'s
  ``timeout``) and the whole run: a rank that raises, exits without a
  result or outlives the deadline gets every rank killed, and ``spmd``
  raises with the failing rank's traceback.

``fn`` and its arguments are pickled by reference, so ``fn`` lives in a
module of this package (a spawned rank imports it, and nothing else of
the caller's).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def rank_device(device: str) -> torch.device:
    """The calling rank's device: ``cuda:<rank>`` or the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", dist.get_rank() if dist.is_initialized() else 0)


def _rank_main(fn: Callable, rank: int, world: int, device: str, tmp: str,
               timeout_s: float, args) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(1)
            kw = {}
        else:
            torch.cuda.set_device(rank)
            kw = {"device_id": torch.device("cuda", rank)}
        dist.init_process_group(
            BACKENDS[device], store=dist.FileStore(os.path.join(tmp, "store"),
                                                   world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
        out = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:  # noqa: BLE001 - reported to the parent
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join()


def spmd(fn: Callable, world: int, device: str, *args: Any,
         timeout_s: float = 300.0) -> Any:
    if device not in BACKENDS:
        raise ValueError(f"spmd: device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    if device == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"spmd: {world} ranks need {world} CUDA devices; "
                         f"{torch.cuda.device_count()} available")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="spmd-") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, device, tmp, timeout_s,
                                   args), daemon=True)
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.start()
        try:
            pending = list(procs)
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spmd: {len(pending)} of {world} ranks still "
                        f"running after {timeout_s} s")
                wait([p.sentinel for p in pending], timeout=left)
                for p in [p for p in pending if p.exitcode is not None]:
                    pending.remove(p)
                    if p.exitcode != 0:
                        r = procs.index(p)
                        path = os.path.join(tmp, f"error{r}.txt")
                        why = (open(path).read() if os.path.exists(path)
                               else f"exit code {p.exitcode}\n")
                        raise RuntimeError(f"spmd: rank {r} of {world} "
                                           f"failed:\n{why}")
        finally:
            _kill(procs)
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


__all__ = ["BACKENDS", "rank_device", "spmd"]
