"""Process groups for data-parallel and multi-host training (port of
genpose2_tpu/parallel/distributed.py over ``torch.distributed``).

The JAX package runs one process per host over all of the host's devices
and lets GSPMD make every reduction global. The port runs one process, a
rank, per GPU, with explicit collectives (``parallel/mesh.py``). A "host" of
the JAX command line is a rank here. Each rank loads its own rows of the
global batch (``host_local_slice``); the step's collectives make the shards
act as one batch.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# the process group's timeout: a collective that waits longer raises
DEFAULT_TIMEOUT_S = 600
_LOCAL = {"rank": 0, "size": 1}  # this rank's index among the ranks of its host, their count


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 when no process group is initialised."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of ranks; 1 when no process group is initialised."""
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """This rank's index among the ranks of its host (its GPU's index)."""
    return _LOCAL["rank"]


def choose_backend(device=None, local_world_size: int = 1):
    """(backend, reason): NCCL where each rank of this host has a GPU of its
    own; gloo on the CPU and where ranks share a GPU (NCCL refuses two ranks
    on one GPU). gloo's all-reduce and broadcast take CUDA tensors."""
    if (device is not None and torch.device(device).type == "cpu") or \
            not torch.cuda.is_available():
        return "gloo", "the ranks run on the CPU"
    gpus = torch.cuda.device_count()
    if local_world_size > gpus:
        return "gloo", f"{local_world_size} ranks share {gpus} GPU(s) of this host"
    return "nccl", "one GPU a rank"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None,
                         backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group from the arguments or the environment:
    COORDINATOR_ADDRESS (host:port) / NUM_PROCESSES / PROCESS_ID as in the
    JAX package, or torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK /
    LOCAL_RANK / LOCAL_WORLD_SIZE. A no-op returning False for one process
    without torchrun's variables; True once the group is up (also when it
    was already). ``device`` 'cpu' runs the ranks on the CPU; otherwise each
    rank's GPU is ``cuda:LOCAL_RANK`` (modulo the GPUs present): one rank a
    GPU, so on a host of several GPUs a rank without LOCAL_RANK raises (one
    process would take cuda:0 alone, or two would share it). The backend
    is NCCL or gloo (``choose_backend``) unless ``backend`` names one; the
    choice is printed."""
    if is_initialized():
        return True
    env = os.environ
    torchrun = "MASTER_ADDR" in env and "WORLD_SIZE" in env
    if num_processes is None:
        num_processes = int(env.get("NUM_PROCESSES") or env.get("WORLD_SIZE") or 1)
    if num_processes <= 1 and not torchrun:
        return False
    if process_id is None:
        process_id = int(env.get("PROCESS_ID") or env.get("RANK") or 0)
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if address is None:
        if not torchrun:
            raise ValueError("multi-host training needs a coordinator address (host:port) "
                             "or torchrun's MASTER_ADDR / MASTER_PORT")
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if ("LOCAL_RANK" not in env and not on_cpu and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        raise ValueError(f"this host has {torch.cuda.device_count()} GPUs and a rank takes one: "
                         "start one process a GPU with LOCAL_RANK and LOCAL_WORLD_SIZE set "
                         "(torchrun sets them)")
    _LOCAL["rank"] = int(env.get("LOCAL_RANK", 0))
    _LOCAL["size"] = int(env.get("LOCAL_WORLD_SIZE", 1))
    reason = "asked for"
    if backend is None:
        backend, reason = choose_backend(device, _LOCAL["size"])
    if backend == "nccl":
        torch.cuda.set_device(_LOCAL["rank"] % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    # one write: the ranks of a host share its stdout
    print(f"genpose2_tpu_torch.parallel: rank {process_id} of {num_processes} "
          f"(local {_LOCAL['rank']} of {_LOCAL['size']}), backend {backend}: {reason}\n",
          end="", flush=True)
    return True


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    if is_initialized():
        dist.destroy_process_group()
    _LOCAL.update(rank=0, size=1)


def barrier() -> None:
    """Wait for every rank; nothing to wait for without a group."""
    if world_size() > 1:
        dist.barrier()


def host_local_slice(global_batch_size: int) -> slice:
    """The rows of the global batch this rank loads. A world size that does
    not divide the global batch raises: a remainder would shrink it."""
    world = world_size()
    if global_batch_size % world:
        raise ValueError(f"the global batch of {global_batch_size} does not split over "
                         f"{world} ranks")
    per_rank = global_batch_size // world
    start = rank() * per_rank
    return slice(start, start + per_rank)


def global_batch_from_host_local(local_batch: dict, mesh) -> dict:
    """This rank's rows of the global batch on the rank's device: each rank's
    batch is its shard, and the step's collectives (``parallel/mesh.py``) make
    the shards act as one batch. Arrays become tensors; other values (file
    names) pass through."""
    from genpose2_tpu_torch.parallel.mesh import to_device

    return {k: to_device(v, mesh.device) for k, v in local_batch.items()}
