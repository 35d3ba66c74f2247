"""Spawn a world of ranks, one process each, and collect what each returns.

    results = run_ranks(fn, 8, arg, backend="gloo")

``fn(*args)`` runs in ``world_size`` processes started with the ``spawn``
method (CUDA forbids ``fork``), each with the default process group
initialised (``file://`` store in a fresh temporary directory, so that
concurrent worlds on one machine never share a port) and PyTorch on
``threads`` intra-op threads. A rank reads its place from
``torch.distributed.get_rank()``. On a machine with CUDA each rank
selects ``cuda:(rank % device_count)``: with one card every rank shares
``cuda:0``, and only gloo, whose collectives ``dist.collectives`` stages
through host memory, runs more than one rank there (NCCL refuses two
ranks on one device).

``fn`` must be importable by name (a module-level function). Tensors in
what it returns come back as numpy arrays. A rank that raises fails the
whole world: its traceback is raised here, and the other ranks are
killed. So is a world that has not finished within ``timeout`` seconds;
every collective also times out after ``pg_timeout`` seconds, so a hung
rank fails instead of waiting forever.

Under ``torchrun`` a program initialises the group itself and calls its
code directly; this helper is for tests and for ``chip_smoke.py``.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch


def to_host(tree: Any) -> Any:
    """Tensors of ``tree`` (nested dicts, lists, tuples) as numpy arrays
    (bfloat16 as float32)."""
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [to_host(v) for v in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")  # NamedTuple
                else type(tree)(items))
    return tree


def _rank_main(call, rank, world_size, init, backend, pg_timeout, threads,
               out):
    import torch.distributed as dist

    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(threads)
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=pg_timeout))
        try:
            result = to_host(fn(*args))
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except Exception:                      # reported, then the rank exits
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo",
              timeout: float = 600.0, pg_timeout: float = 60.0,
              threads: int = 1) -> List[Any]:
    """``fn(*args)`` on ``world_size`` spawned ranks; returns the list of
    their results by rank."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks")
    init = "file://" + os.path.join(tmp, "pg")
    # The call goes through a file: a spawned process reads its arguments
    # from a pipe that the parent fills one process at a time, so large
    # arguments would serialise the ranks' start-up.
    call = os.path.join(tmp, "call.pkl")
    with open(call, "wb") as f:
        pickle.dump((fn, args), f)
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(call, r, world_size, init, backend,
                               pg_timeout, threads, out))
             for r in range(world_size)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world_size - len(results)} of {world_size} ranks "
                    f"did not finish within {timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
