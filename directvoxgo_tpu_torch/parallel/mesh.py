"""Data parallelism over rays, on ``torch.distributed``.

One rank per card (or per CPU process, on the gloo backend): every rank
holds the whole model, optimizer state and ray pool, draws the same batch
from the same seed, and takes its contiguous block of the batch's rays
(:func:`shard_rays`, the block ``P("data")`` gives a device of a 1-D
mesh). The gradients of a step are averaged over the ranks in one
all-reduce of one flat buffer (:func:`all_reduce_mean`), so every rank
applies the same update to the same replicated state.

A :class:`DataMesh` is one rank's handle on the data axis: its process
group, rank, world size, backend and device. The backend is NCCL on CUDA
devices and gloo on the CPU unless the caller names one (gloo also takes
CUDA tensors, which is how two ranks share one card: NCCL refuses that).

Usage::

    mesh = make_mesh("cuda:0", init_method="tcp://localhost:29500",
                     world_size=2, rank=0)
    step = make_train_step(..., group=mesh)
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class DataMesh:
    """One rank of the data axis: ``group`` (None: the default process
    group), ``rank``, ``world``, ``backend`` and the rank's ``device``."""

    def __init__(self, group, rank, world, backend, device):
        self.group, self.rank, self.world = group, int(rank), int(world)
        self.backend, self.device = backend, torch.device(device)

    @property
    def graphable(self):
        """Whether a train step's collective can be captured in a CUDA
        graph (NCCL's can, gloo's cannot)."""
        return self.backend == "nccl"

    def block(self, n):
        """This rank's contiguous block ``(start, stop)`` of ``n`` rows."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} "
                             "ranks")
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(device, backend=None, init_method=None, world_size=None,
              rank=None, store=None):
    """Join the default process group (made here unless it exists) and
    return this rank's :class:`DataMesh` on ``device``. ``backend``:
    NCCL for a CUDA device, gloo for the CPU, unless named. The group's
    address comes from ``init_method`` (``tcp://localhost:<port>``,
    ``file://...``; ``env://`` by default, as ``torchrun`` sets it) or a
    ``store``. On NCCL one collective runs here, so that the communicator
    exists before a train step is captured as a CUDA graph."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        kw = {}
        if store is not None:
            kw["store"] = store
        else:
            kw["init_method"] = init_method or "env://"
        if world_size is not None:
            kw["world_size"] = int(world_size)
        if rank is not None:
            kw["rank"] = int(rank)
        dist.init_process_group(backend, **kw)
    mesh = DataMesh(None, dist.get_rank(), dist.get_world_size(),
                    dist.get_backend(), device)
    if mesh.backend == "nccl":
        warm = torch.ones(1, device=device)
        dist.all_reduce(warm)
        torch.cuda.synchronize(device)
    return mesh


def shard_rays(mesh, x):
    """This rank's contiguous block of the leading (ray) axis of ``x``."""
    start, stop = mesh.block(x.shape[0])
    return x[start:stop]


def shard_batch_tree(mesh, tree):
    """:func:`shard_rays` over every tensor of a dict, list or tuple."""
    if isinstance(tree, dict):
        return {k: shard_batch_tree(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch_tree(mesh, v) for v in tree)
    return shard_rays(mesh, tree)


@torch.no_grad()
def replicate(mesh, tensors):
    """Overwrite ``tensors`` on every rank with rank 0's, in place: a guard
    for state that every rank builds identically."""
    for t in tensors:
        dist.broadcast(t.data, src=0, group=mesh.group)


@torch.no_grad()
def replica_spread(mesh, tensors):
    """The largest ``|t - rank 0's t|`` over ``tensors`` and the ranks (0.0
    when the replicas agree bit for bit), the same on every rank."""
    worst = torch.zeros((), dtype=torch.float64, device=mesh.device)
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, src=0, group=mesh.group)
        if ref.numel():
            worst = torch.maximum(worst, (ref.double() - t.double()).abs()
                                  .max())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(worst)


def all_reduce_mean(mesh, tensors):
    """The mean over the ranks of each of ``tensors``, through one
    all-reduce of one flat buffer per dtype; returns views of those
    buffers in the tensors' shapes. With one rank the values come back
    unchanged."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = [None] * len(tensors)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        if mesh.world > 1:
            flat.div_(mesh.world)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view(tensors[i].shape)
            at += n
    return out


def all_gather_rays(mesh, x):
    """The ranks' blocks ``x`` joined in rank order along the ray axis."""
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)
