"""Data parallelism over ``torch.distributed``: the counterpart of the JAX
package's parallel/mesh.py.

The JAX package declares a ("data", "model") mesh, shards the batch axis
over "data", keeps the parameters replicated and lets XLA insert the
collectives. Here each rank is one process that holds a copy of the
parameters and its own contiguous rows of the global batch, and the
collectives that XLA would insert are written out where the JAX program
has them:

  * the gradient sum of a train step: one flattened all-reduce
    (``all_reduce_sum_``; train/loop.py, train/proposal_loop.py). The steps
    take gradients with ``torch.autograd.grad``, which bypasses the
    ``AccumulateGrad`` hooks that ``DistributedDataParallel`` reduces on, so
    DDP would reduce nothing here;
  * the global denominators of the masked-mean losses (train/losses.py)
    and train-mode BatchNorm's batch statistics (models/layers.py), through
    ``all_reduce_sum`` (differentiable);
  * the engine's labels and assignments, gathered back to the whole batch
    on every rank (``all_gather_rows``; infer/engine.py).

Backends: ``nccl`` when every rank has a card of its own, ``gloo`` on the
CPU and for ranks that share a card (NCCL refuses two ranks on one
device). gloo takes the CUDA tensors of every collective used here as
they are (all-reduce, broadcast, all-gather); the computation stays on the
card either way.

``launch`` starts the ranks: under torchrun's environment it joins that
group, a world of one runs in this process, and otherwise it spawns one
process per rank, which meet at a ``file://`` store in a fresh temporary
directory (no TCP port to collide on).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# A rank that dies leaves its peers blocked in a collective; the launcher
# then stops them, and this bounds the wait of ranks started elsewhere.
_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """The ("data", "model") mesh of a process group, ``model`` = 1 as in
    the JAX package: this rank, the world size and this rank's device."""

    rank: int
    world: int
    device: torch.device
    group: Any = None            # None: the default group

    @property
    def shape(self) -> dict:
        return {"data": self.world, "model": 1}

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``."""
        if n % self.world:
            raise ValueError(f"batch {n} not divisible by mesh data axis "
                             f"{self.world}")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def barrier(self) -> None:
        """Return when every rank has called it (a one-element all-reduce,
        read back, on this rank's device)."""
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.group)
        t.item()


def backend_for(world: int, device_type: str) -> str:
    """nccl when each of ``world`` ranks has its own card, else gloo."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def visible_ranks(device) -> int:
    """The ranks a CLI's data parallelism spans: those of an initialised
    group or of torchrun's, else one per visible card (one on the CPU)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """The mesh of the initialised default group (see ``launch``): all its
    ranks on "data". ``device_type`` is CUDA unless the caller asks for
    another; a CUDA rank takes card ``LOCAL_RANK`` modulo the cards there
    are, and makes it its current device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "start the ranks with parallel.launch or torchrun")
    if model != 1:
        raise ValueError(f"model axis {model}: only data parallelism "
                         "(model=1) is implemented, as in the JAX package")
    world = dist.get_world_size()
    if data is not None and data != world:
        raise ValueError(f"mesh data={data} needs {data} ranks, the group "
                         f"has {world}")
    device_type = device_type or "cuda"
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                               "to run the ranks on the CPU")
        device = torch.device("cuda", _local_rank() % n)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    return Mesh(rank=dist.get_rank(), world=world, device=device)


# -- collectives ------------------------------------------------------------

def _map_rows(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_rows(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_rows(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)) and tree.ndim > 0:
        return fn(tree)
    return tree


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous rows of axis 0 of every array or tensor in
    ``batch`` (nested dicts, lists, tuples; scalars and other leaves are
    kept). Raises when a batch does not divide over the mesh."""
    return _map_rows(lambda x: x[mesh.rows(x.shape[0])], batch)


@torch.no_grad()
def replicate_(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
    return module


@torch.no_grad()
def all_reduce_sum_(tensors: Sequence[torch.Tensor], mesh: Mesh
                    ) -> Sequence[torch.Tensor]:
    """Sum ``tensors`` (one dtype, one device) over the ranks in place, with
    one all-reduce of their concatenation."""
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks' upstream
    gradients (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable (a new tensor)."""
    return _AllReduceSum.apply(t, mesh.group)


def all_gather_rows(t, mesh: Mesh) -> torch.Tensor:
    """The inverse of ``shard_batch`` for one tensor (or array): every
    rank's rows of axis 0, concatenated in rank order, on every rank."""
    t = torch.as_tensor(t).contiguous()
    outs = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(outs, t, group=mesh.group)
    return torch.cat(outs)


# -- launching ranks --------------------------------------------------------

def _init(backend: str, rank: int, world: int, init_method: str) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=_TIMEOUT)


def _spawned_rank(rank: int, fn: Callable, args: tuple, world: int,
                  device_type: str, tmp: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    _init(backend_for(world, device_type), rank, world,
          f"file://{os.path.join(tmp, 'store')}")
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _gather_results(out) -> List[Any]:
    results = [None] * dist.get_world_size()
    dist.all_gather_object(results, out)
    return results


def launch(fn: Callable, world: int, device_type: str = "cuda",
           *args) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks, each inside the process group,
    and return every rank's result in rank order (results must pickle).

    Inside an initialised group, or under torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), this process is one of the
    ranks and runs ``fn`` itself; torchrun's group is joined here and left
    when ``fn`` returns. A world of one is a group of this process alone,
    made and left here. Otherwise ``world`` processes are spawned (the
    ``spawn`` start method: ``fn`` must be importable at module level) and
    meet at a ``file://`` store in a fresh temporary directory. A rank that
    raises makes ``launch`` raise; no rank falls back to a single process."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"launch: {world} ranks asked for inside a group "
                             f"of {dist.get_world_size()}")
        return _gather_results(fn(*args))
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        env_world = int(os.environ["WORLD_SIZE"])
        if env_world != world:
            raise ValueError(f"launch: {world} ranks asked for, torchrun "
                             f"started {env_world}")
        _init(backend_for(world, device_type), int(os.environ["RANK"]), world,
              "env://")
        try:
            return _gather_results(fn(*args))
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="dmm_ranks_")
    try:
        if world == 1:
            _init(backend_for(1, device_type), 0, 1,
                  f"file://{os.path.join(tmp, 'store')}")
            try:
                return [fn(*args)]
            finally:
                dist.destroy_process_group()
        mp.start_processes(_spawned_rank,
                           args=(fn, tuple(args), world, device_type, tmp),
                           nprocs=world, start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))      # written by our ranks
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
