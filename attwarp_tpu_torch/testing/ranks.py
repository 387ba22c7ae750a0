"""Spawned ranks: run one function in ``world`` processes joined in a
``torch.distributed`` group, and bring each rank's result back.

``run_ranks(fn, world, args)`` starts the processes with the ``spawn``
method (so CUDA is first touched in each child, never inherited), has each
join the group through a ``file://`` rendezvous in a fresh temporary
directory, runs ``fn(rank, world, *args)`` and returns every rank's return
value in rank order (anything picklable, CPU tensors and numpy arrays
included, which travel by value). ``fn``
must be importable by name from a module that imports neither JAX nor
the JAX package, since each child imports it.

A rank that raises, exits non-zero or outlives ``timeout`` fails the whole
call: the others are stopped and a ``RuntimeError`` carries the failing
rank's traceback. Every collective has the group's timeout
(``parallel/mesh.py::COLLECTIVE_TIMEOUT``), so a rank whose peer died does
not wait forever either.
"""

from __future__ import annotations

import pickle
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, backend: str, init: str, fn: Callable,
               args: Sequence, results) -> None:
    import torch
    import torch.distributed as dist

    from attwarp_tpu_torch.parallel.mesh import init_ranks

    # ranks share the host's cores
    torch.set_num_threads(1)
    try:
        init_ranks(backend, rank, world, init)
        # by value: a tensor put on the queue as is would travel as a shared
        # memory handle that dies with this process
        results.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
              timeout: float = 600.0) -> List[Any]:
    """``fn(rank, world, *args)`` in ``world`` spawned ranks, one CPU
    thread each; their return values in rank order (see the module
    docstring)."""
    ctx = mp.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="attwarp_ranks_"))
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, f"file://{tmp / 'rendezvous'}", fn,
                               tuple(args), results))
             for r in range(world)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"run_ranks: {world - len(out)} of {world} ranks gave "
                                   f"no result within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"run_ranks: a rank exited with code {dead[0]} "
                                       f"before reporting")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {world} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 30.0))
            if p.exitcode != 0:
                raise RuntimeError(f"run_ranks: a rank exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
