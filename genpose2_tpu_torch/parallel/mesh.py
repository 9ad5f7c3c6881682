"""Data- and candidate-parallel execution over ranks (port of
genpose2_tpu/parallel/mesh.py).

The JAX package lays one process's devices out as a ``('data', 'cand')``
``Mesh``: batches are sharded on their leading axis, parameters replicated,
and under ``jit`` GSPMD makes every reduction global. Here each rank is one
process on one device, ranks are laid out row-major over ``(data, cand)``
(rank = data_index * cand + cand_index), and the reductions are explicit:

- ``replicate``: every tensor of a train state, a module or a dict broadcast
  from rank 0;
- ``shard_batch`` / ``shard_stacked_batch`` / ``shard_candidates``: this
  rank's block of a global batch, on its device; ``gather_candidates`` puts
  (B, K, ...) blocks back together (in JAX a sharded array is global);
- inside ``use_mesh(mesh)`` a training step reduces over the ``data`` ranks:
  ``models/layers.py:batch_norm`` takes the global batch's statistics
  (``Mesh.batch_moments``), the agents average gradients, loss and metrics
  (``Mesh.mean_gradients``, ``Mesh.mean_metrics``), and ``batch_rand`` /
  ``batch_randn`` draw at the global batch's shape from the step's generator,
  seeded alike on every rank, and keep this rank's rows, so that the ranks
  reproduce one process on the whole batch.

Shards are equal (``shard_batch`` and ``distributed.host_local_slice`` raise
otherwise; a sharded ``DataLoader`` gives every rank batches of one size),
so a global mean is the mean of the ranks' means.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from genpose2_tpu_torch.parallel.distributed import (is_initialized, local_rank, rank,
                                                     world_size)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, cand) layout of ranks. ``data_group`` is
    the group over which a batch's rows are split (None: no collective, one
    rank holds every row). ``stats`` counts each kind of collective (count, bytes, seconds); with
    ``time_collectives`` the seconds are the collective's own, the device
    synchronised before and after (for measurement runs only)."""

    data: int
    cand: int
    data_index: int
    cand_index: int
    device: torch.device
    data_group: Optional[object] = None
    time_collectives: bool = False
    stats: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: {"count": 0, "bytes": 0,
                                                                 "s": 0.0}))

    @contextlib.contextmanager
    def _record(self, kind: str, nbytes: int):
        if self.time_collectives:
            _synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.time_collectives:
            _synchronize(self.device)
        rec = self.stats[kind]
        rec["count"] += 1
        rec["bytes"] += int(nbytes)
        rec["s"] += time.perf_counter() - t0

    def batch_moments(self, mean: torch.Tensor, msq: torch.Tensor):
        """The global batch's E[x] and E[x^2] from this rank's (per channel):
        one differentiable float32 all-reduce of both over the data ranks,
        whose backward sums the gradients over the ranks, so that each
        rank's input gradient holds the other ranks' share of the
        statistics. Both all-reduces are recorded: 'batch_norm' and
        'batch_norm_backward'."""
        if self.data_group is None:
            return mean, msq
        both = torch.stack([mean, msq]) * (1.0 / self.data)
        with self._record("batch_norm", both.numel() * both.element_size()):
            both = _AllReduceSum.apply(both, self)
        return both[0], both[1]

    def mean_gradients(self, params: List[torch.Tensor],
                       grads: List[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """The gradients averaged over the data ranks, a missing one counted
        as zeros: one flattened buffer a dtype, one all-reduce each."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if self.data_group is None:
            return grads
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        by_dtype = collections.defaultdict(list)
        for i, g in enumerate(grads):
            by_dtype[g.dtype].append(i)
        for idx in by_dtype.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            with self._record("gradients", flat.numel() * flat.element_size()):
                dist.all_reduce(flat, group=self.data_group)
            flat.div_(self.data)
            for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = piece.view_as(grads[i])
        return out

    def mean_metrics(self, loss: torch.Tensor, metrics: dict):
        """(loss, metrics) averaged over the data ranks in one all-reduce;
        metrics that are not tensors (the learning rate) as they are."""
        if self.data_group is None:
            return loss, metrics
        keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
        buf = torch.stack([loss.detach().float()] + [metrics[k].detach().float() for k in keys])
        with self._record("metrics", buf.numel() * buf.element_size()):
            dist.all_reduce(buf, group=self.data_group)
        buf.div_(self.data)
        return buf[0], {**metrics, **{k: buf[i + 1] for i, k in enumerate(keys)}}


class _AllReduceSum(torch.autograd.Function):
    """A sum over a mesh's data ranks whose backward is the same sum of the
    gradients, recorded in the mesh's stats as 'batch_norm_backward'."""

    @staticmethod
    def forward(ctx, tensor, mesh):
        ctx.mesh = mesh
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=mesh.data_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        with ctx.mesh._record("batch_norm_backward", grad.numel() * grad.element_size()):
            grad = _AllReduceSum.apply(grad, ctx.mesh)
        return grad, None


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_device(device=None) -> torch.device:
    """A rank's device: ``device`` when it names a CPU or an indexed GPU,
    else ``cuda:LOCAL_RANK`` (modulo the GPUs present; ranks beyond them share
    GPUs). Without a card and without an explicit device it raises."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks "
                           "on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def make_mesh(data: int = 0, cand: int = 1, device=None) -> Mesh:
    """A (data x cand) layout of the process group's ranks; ``data=0`` means
    every rank over ``cand``. Without a process group it is the one-rank
    mesh of this process, with no collective. Every rank calls it (it makes
    the data axis's sub-groups when both axes exceed 1)."""
    world, r = world_size(), rank()
    if data == 0:
        data = world // cand
    if data * cand != world:
        raise ValueError(f"a ({data}, {cand}) mesh needs {data * cand} ranks, not {world}")
    di, ci = divmod(r, cand)
    data_group = None
    if is_initialized() and cand == 1:
        data_group = dist.group.WORLD
    elif is_initialized() and data > 1:
        for c in range(cand):  # every rank makes every group, in one order
            g = dist.new_group([d * cand + c for d in range(data)])
            data_group = g if c == ci else data_group
    return Mesh(data, cand, di, ci, mesh_device(device), data_group)


_ACTIVE: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the block under ``mesh`` (training steps reduce over its data
    ranks and draw at the global batch's shape); None changes nothing."""
    if mesh is None:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def _batch_draw(fn, shape, generator, device, batch_axis: int, **kw) -> torch.Tensor:
    mesh = active_mesh()
    if mesh is None or mesh.data == 1:
        return fn(tuple(shape), generator=generator, device=device, **kw)
    full = list(shape)
    n = full[batch_axis]
    full[batch_axis] = n * mesh.data
    out = fn(tuple(full), generator=generator, device=device, **kw)
    return out.narrow(batch_axis, mesh.data_index * n, n)


def batch_rand(shape, generator: Optional[torch.Generator] = None, device=None,
               batch_axis: int = 0, **kw) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows (``batch_axis``) of a batch:
    under an active mesh the draw is made at the global batch's shape and
    this rank's rows are kept."""
    return _batch_draw(torch.rand, shape, generator, device, batch_axis, **kw)


def batch_randn(shape, generator: Optional[torch.Generator] = None, device=None,
                batch_axis: int = 0, **kw) -> torch.Tensor:
    """``torch.randn`` as ``batch_rand`` draws ``torch.rand``."""
    return _batch_draw(torch.randn, shape, generator, device, batch_axis, **kw)


def to_device(x, device):
    """Tensors and numeric arrays (in lists too) on ``device``; other values
    as they are."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, np.ndarray) and x.dtype.kind in "biuf":
        return torch.as_tensor(x).to(device)
    if isinstance(x, (list, tuple)) and x and (torch.is_tensor(x[0]) or
                                               isinstance(x[0], np.ndarray)):
        return type(x)(to_device(v, device) for v in x)
    return x


def _rows(x, index: int, parts: int, axis: int, what: str):
    """Block ``index`` of ``parts`` equal blocks of x along ``axis``."""
    if isinstance(x, dict):
        return {k: _rows(v, index, parts, axis, f"{what}[{k!r}]") for k, v in x.items()}
    if isinstance(x, (list, tuple)) and x and (torch.is_tensor(x[0]) or
                                               isinstance(x[0], np.ndarray)):
        return type(x)(_rows(v, index, parts, axis, what) for v in x)
    if torch.is_tensor(x) or isinstance(x, np.ndarray) or (axis == 0 and isinstance(x, list)):
        size = x.shape[axis] if not isinstance(x, list) else len(x)
        if size % parts:
            raise ValueError(f"{what}: {size} rows on axis {axis} do not split into {parts}")
        n = size // parts
        if isinstance(x, list):
            return x[index * n:(index + 1) * n]
        sl = (slice(None),) * axis + (slice(index * n, (index + 1) * n),)
        return x[sl]
    return x


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows (its data index's block of the leading axis) of a
    global batch, on its device."""
    return {k: to_device(v, mesh.device)
            for k, v in _rows(batch, mesh.data_index, mesh.data, 0, "batch").items()}


def shard_stacked_batch(batches: dict, mesh: Mesh) -> dict:
    """This rank's rows of a stacked (S, B, ...) batch: axis 1, on its device."""
    return {k: to_device(v, mesh.device)
            for k, v in _rows(batches, mesh.data_index, mesh.data, 1, "batch").items()}


def shard_candidates(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's (B / data, K / cand, ...) block of a (B, K, ...) tensor."""
    x = _rows(x, mesh.data_index, mesh.data, 0, "candidates")
    return _rows(x, mesh.cand_index, mesh.cand, 1, "candidates").to(mesh.device)


def gather_candidates(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The (B, K, ...) tensor from every rank's ``shard_candidates`` block of
    it (an all-gather over every rank): what JAX's sharded array is already."""
    if not is_initialized() or mesh.data * mesh.cand == 1:
        return block
    block = block.contiguous()
    parts = [torch.empty_like(block) for _ in range(mesh.data * mesh.cand)]
    with mesh._record("gather", block.numel() * block.element_size() * len(parts)):
        dist.all_gather(parts, block)
    rows = [torch.cat(parts[d * mesh.cand:(d + 1) * mesh.cand], dim=1) for d in range(mesh.data)]
    return torch.cat(rows, dim=0)


def _leaves(tree, tensors: list, scalars: list) -> None:
    """The tensors of a tree (train state, module, dict, list) and its int or
    float entries, as (container, key, type)."""
    if tree is None:
        return
    if torch.is_tensor(tree):
        tensors.append(tree)
        return
    if isinstance(tree, torch.nn.Module):
        tensors.extend(tree.state_dict().values())
        return
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, tensors, scalars)
        return
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        raise TypeError(f"replicate: cannot walk a {type(tree).__name__}")
    for k, v in items:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            scalars.append((tree, k, type(v)))
        else:
            _leaves(v, tensors, scalars)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Every tensor (and int or float entry) of ``tree`` set to rank 0's, in
    place, by broadcasts over every rank: one flattened buffer a dtype. A
    module contributes its whole ``state_dict()`` (its fixed random
    projections and BatchNorm statistics too). Returns ``tree``."""
    if not is_initialized():
        return tree
    tensors: list = []
    scalars: list = []
    _leaves(tree, tensors, scalars)
    seen, groups = set(), collections.defaultdict(list)
    for t in tensors:
        key = (t.data_ptr(), t.numel(), t.dtype)
        if t.numel() and key not in seen:
            seen.add(key)
            groups[t.dtype].append(t.detach())
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1).to(mesh.device) for t in ts])
        with mesh._record("replicate", flat.numel() * flat.element_size()):
            dist.broadcast(flat, src=0)
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))
    if scalars:
        def get(c, k):
            return getattr(c, k) if dataclasses.is_dataclass(c) else c[k]

        buf = torch.tensor([float(get(c, k)) for c, k, _ in scalars], dtype=torch.float64,
                           device=mesh.device)
        dist.broadcast(buf, src=0)
        for (c, k, typ), v in zip(scalars, buf.tolist()):
            if dataclasses.is_dataclass(c):
                setattr(c, k, typ(v))
            else:
                c[k] = typ(v)
    return tree
