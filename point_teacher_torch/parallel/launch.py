"""A world of N ranks in spawned processes on one host (the port's
`--cpu-devices N`; the root CLIs' virtual CPU devices).

    spawn(fn, n, *args)

starts N processes with the "spawn" method (fork would copy a parent that
may hold JAX or a CUDA context), each on one torch thread, joins them into
one process group through a file store in a fresh temporary directory (no
fixed TCP port, so that several worlds can run at once), calls fn(*args) on
every rank and leaves the group. A rank that raises ends the world: the
others are killed and the error, with the rank's traceback, is raised in
the caller, the first rank's to fail first (the others then fail in their
collectives, and their errors follow). With a `timeout`, a world that has
not ended within it is killed and TimeoutError raised, and a collective
waits at most as long, so a hang fails instead of waiting forever.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Optional

import torch
import torch.multiprocessing as mp

from . import dist


def _rank_main(index: int, fn, n: int, store: str, backend: str, timeout, args) -> None:
    torch.set_num_threads(1)
    dist.init(backend, f"file://{store}", index, n,
              timeout=dist.TIMEOUT if timeout is None else timedelta(seconds=timeout))
    try:
        fn(*args)
    finally:
        dist.shutdown()


def spawn(fn, n: int, *args, backend: str = "gloo", timeout: Optional[float] = None) -> None:
    """Run fn(*args) on each of `n` ranks of one `backend` world (see the
    module docstring). `fn` must be picklable: a module-level function."""
    tmp = tempfile.mkdtemp(prefix="pt_world_")
    ctx = mp.start_processes(_rank_main, args=(fn, n, os.path.join(tmp, "store"), backend,
                                               timeout, args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5, grace_period=5.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"a world of {n} ranks did not end within {timeout:.0f} s")
    except mp.ProcessRaisedException as e:
        raise RuntimeError(_rank_errors(ctx.error_files)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_errors(error_files) -> str:
    """The tracebacks the failed ranks left, the earliest first."""
    found = []
    for index, path in enumerate(error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                found.append((os.path.getmtime(path), index, pickle.load(f)))
    return "".join(f"\n-- rank {index} failed:\n{tb}" for _, index, tb in sorted(found))
