"""Start a run's ranks as processes of this host (``torchrun``'s job, for
scripts and tests that start their own ranks).

:func:`spawn` starts ``fn(rank, world_size, init_method, *args)`` in
``world_size`` processes with the ``spawn`` method (a parent that already
holds CUDA cannot fork), their rendezvous a ``file://`` store in a fresh
temporary directory (no port to collide with another run). The parent
collects each rank's return value, joins them under one deadline, and kills
them all when any rank fails or the deadline passes, raising with the
failed rank's traceback. ``fn`` must be a module-level function of a module
the children can import; they import that module and the port, nothing
else of the parent's.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List


def _entry(job, rank, world_size, init_method, results):
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        # pickled here, tensors in band: a rank may exit before the parent
        # reads its result, so nothing may be left in shared memory
        results.put((rank, "ok", pickle.dumps(fn(rank, world_size, init_method, *args))))
    except BaseException:  # reported to the parent, which kills the other ranks
        results.put((rank, "error", traceback.format_exc()))
        raise


def spawn(fn: Callable, world_size: int, args: tuple = (),
          timeout: float = 300.0) -> List[Any]:
    """Run ``fn`` on ``world_size`` ranks; returns their results by rank."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mt_rendezvous_")
    init_method = "file://" + os.path.join(tmp, "store")
    # the function and its arguments go through a file: ``start`` writes
    # what it hands a child into a pipe and waits until the child, which
    # first imports the main module, has read it, so large arguments handed
    # over that way would start the ranks one after another
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = []
    for rank in range(world_size):
        p = ctx.Process(target=_entry, args=(job, rank, world_size, init_method, results),
                        daemon=False)
        p.start()
        procs.append(p)
    out: List[Any] = [None] * world_size
    deadline = time.monotonic() + timeout
    pending = set(range(world_size))
    failure = None
    try:
        while pending and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"ranks {sorted(pending)} did not finish within {timeout:.0f} s"
                break
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r in pending if not procs[r].is_alive()
                        and procs[r].exitcode not in (0, None)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                               "before it returned")
                continue
            pending.discard(rank)
            if status == "ok":
                out[rank] = pickle.loads(value)
            else:
                failure = f"rank {rank} failed:\n{value}"
        if failure is None:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return out
