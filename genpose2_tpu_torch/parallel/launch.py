"""Start N ranks on this machine: what ``--data_parallel N`` means in the
port (the JAX package runs N local devices in one process).

``launch(fn, n, args)`` spawns n processes (``torch.multiprocessing``, the
``spawn`` method: each re-imports ``fn``'s module, so ``fn`` lives at a
module's top level and that module imports cleanly). Each joins a process
group on a fresh free port of localhost through ``initialize_multihost``'s
torchrun path (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
LOCAL_WORLD_SIZE), runs ``fn(*args)``, and leaves the group. The group has a
timeout, so does the wait for the ranks; the first rank that fails stops the
others, and the launch raises with its traceback.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback
from typing import Callable, Sequence

import torch.multiprocessing as mp

from genpose2_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT_S


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(r: int, n: int, port: int, device, timeout_s: float, fn: Callable,
               args: Sequence, results) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                      RANK=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n))
    try:
        from genpose2_tpu_torch.parallel.distributed import initialize_multihost, shutdown

        initialize_multihost(device=device, timeout_s=timeout_s)
        try:
            out = fn(*args)
        finally:
            shutdown()
        # by value: a tensor shared through torch's queue would outlive its process
        results.put((r, True, pickle.dumps(out)))
    except BaseException:
        results.put((r, False, traceback.format_exc()))
        raise


def launch(fn: Callable, nprocs: int, args: Sequence = (), device=None,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``nprocs`` ranks of this machine; returns their
    return values (picklable, on the CPU) in rank order. ``device`` 'cpu' puts the ranks
    on the CPU (gloo); else each takes ``cuda:rank`` modulo the GPUs, over
    NCCL where each has a GPU of its own and gloo where they share one.
    Raises when a rank raises or dies, or after ``timeout_s`` seconds; no
    rank outlives the call."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, port, device, timeout_s, fn, tuple(args), results),
                         daemon=False)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    outs: dict = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(outs) < nprocs and failure is None:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if i not in outs and p.exitcode is not None]
                if dead:
                    # a rank that died without reporting (killed, crashed)
                    time.sleep(1.0)  # its report may still be in the pipe
                    if results.empty():
                        failure = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                   "without a result")
                elif time.monotonic() > deadline:
                    failure = f"the launch of {nprocs} ranks outlasted {timeout_s} s"
                continue
            if ok:
                outs[r] = pickle.loads(value)
            else:
                failure = f"rank {r} failed:\n{value}"
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()) if failure is None else 5.0)
    finally:
        for p in procs:  # stragglers: a peer that failed leaves the rest in a collective
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [outs[r] for r in range(nprocs)]
