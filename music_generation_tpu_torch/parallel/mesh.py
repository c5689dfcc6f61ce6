"""Device meshes, the tensor-parallel rule and the collectives of the
multi-device paths.

Twin of music_generation_tpu/parallel/mesh.py, whose names it keeps. The
JAX package lays a (data, model) mesh over the devices of one program and
lets XLA insert the collectives. The port has two shapes of it:

- Training runs one process per device. ``init_distributed`` joins the
  torch.distributed process group (NCCL on CUDA, gloo on the CPU) and
  ``make_hybrid_mesh`` lays a (data, model) DeviceMesh over it with
  ``model`` inside a host. Every process feeds its own rows
  (``put_global_batch``): the global batch is their concatenation in rank
  order. ``StepMesh`` is what the training step needs of it: the losses'
  global denominators, this rank's rows of a global draw, the gradient
  all-reduce and the large weights held as shards over ``model``
  (``ShardedParams``).
- Serving is one process. ``make_mesh`` gives an [n_data][n_model] grid of
  torch devices: SVSSynthesizer runs each data row's sentences on its row
  and splits the row's large weights over its devices.

The collectives are torch.distributed's all_reduce and all_gather (the
JAX package has no kernel of its own for them; XLA inserts them).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> list:
    """An [n_data][n_model] grid of torch devices from ``devices`` (default:
    every CUDA device), row-major; ``n_data`` defaults to as many rows as
    the devices fill. Raises ValueError, naming the count, when fewer
    devices exist than n_data x n_model."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    need = n_data * n_model
    if n_data < 1 or n_model < 1 or need > len(devices):
        raise ValueError(f"a {n_data}x{n_model} mesh needs {need} devices; "
                         f"{len(devices)} available")
    return [devices[r * n_model: (r + 1) * n_model] for r in range(n_data)]


def mesh_shape(mesh) -> dict:
    """{"data": n, "model": m} of a make_mesh grid or a DeviceMesh."""
    if isinstance(mesh, list):
        return {"data": len(mesh), "model": len(mesh[0])}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def param_partition_spec(path, value: torch.Tensor, n_model: int,
                         min_size: int = 2 ** 16) -> tuple:
    """The tensor-parallel rule: the last axis of a weight of at least two
    dimensions, at least ``min_size`` elements and a last axis divisible by
    ``n_model`` is split over ``model``; anything else is replicated. The
    JAX PartitionSpec as a tuple: (None, ..., "model") or ()."""
    if (value.ndim >= 2 and value.numel() >= min_size
            and value.shape[-1] % n_model == 0 and n_model > 1):
        return (None,) * (value.ndim - 1) + ("model",)
    return ()


def jax_last_axis(module: nn.Module, leaf: str, value: torch.Tensor) -> int:
    """The axis of a port parameter that is the last axis of its JAX twin
    (the layouts of compat.from_jax): the output axis of a conv or linear
    weight (0; 1 for a transposed conv's [in, out, k]), else the last."""
    from ..core.layers import Conv1d, ConvTranspose1d
    if leaf == "weight":
        if isinstance(module, ConvTranspose1d):
            return 1
        if isinstance(module, (Conv1d, nn.Conv1d, nn.Conv2d, nn.Linear)):
            return 0
    return value.ndim - 1


def param_shardings(module: nn.Module, n_model: int,
                    min_size: int = 2 ** 16) -> dict:
    """{parameter name: the axis the rule splits over ``model``, or None}:
    param_partition_spec applied to each parameter as its JAX twin lays it
    out (jax_last_axis), so the port splits what the JAX package splits."""
    out = {}
    for name, p in module.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        axis = jax_last_axis(module.get_submodule(mod_name), leaf, p)
        spec = param_partition_spec(name, p.movedim(axis, -1), n_model,
                                    min_size)
        out[name] = axis if spec else None
    return out


def shard_params(module: nn.Module, n_model: int, model_rank: int,
                 group=None, min_size: int = 2 ** 16) -> "ShardedParams":
    """The module's weights that the rule splits, as this rank's shards
    (ShardedParams); their full tensors leave the module."""
    return ShardedParams(module, n_model, model_rank, group, min_size)


def init_distributed(device_type: str, coordinator: Optional[str] = None,
                     nprocs: Optional[int] = None,
                     proc_id: Optional[int] = None) -> tuple[int, int]:
    """Join the process group: NCCL on CUDA, gloo on the CPU. With
    ``coordinator`` (HOST:PORT) the rendezvous is tcp:// with ``nprocs``
    and ``proc_id``; without it, torchrun's environment (env://: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK), as jax.distributed.initialize() detects
    its cluster. Returns (rank, world size)."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    if coordinator:
        if nprocs is None or proc_id is None:
            raise ValueError("--coordinator needs --nprocs and --proc-id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=nprocs, rank=proc_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def local_device(device_type: str) -> torch.device:
    """This process's device: on CUDA the one of its local rank
    (LOCAL_RANK, else the rank modulo the host's device count)."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def make_hybrid_mesh(n_model: int = 1, device_type: Optional[str] = None):
    """A (data, model) DeviceMesh over the process group, ``model`` the
    fastest axis: ranks d * n_model .. d * n_model + n_model - 1 form a
    model group, so on hosts of whole model groups it stays inside a host
    (NVLink) and ``data`` crosses hosts. Needs init_distributed first."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world % n_model:
        raise ValueError(f"{world} processes do not split into model groups "
                         f"of {n_model}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // n_model, n_model),
                            mesh_dim_names=("data", "model"))


def batch_sharding(mesh) -> tuple[int, int]:
    """(ranks, rank) of the batch axis over a make_hybrid_mesh DeviceMesh:
    the global batch is the concatenation of every process's rows, in
    rank order, over both of its axes."""
    return mesh.size(), mesh.get_rank()


def put_global_batch(batch: dict, device) -> dict:
    """This process's rows of the global batch on its device (each process
    feeds only its own rows, as jax.make_array_from_process_local_data)."""
    from ..train.data import to_device
    return to_device(batch, device)


class ShardedParams:
    """A module's large weights (param_shardings) held as this rank's block
    of the axis the rule splits, as leaf parameters that the optimizer
    updates. ``gather()`` rebuilds the full weights with a differentiable
    all_gather over the model group: the backward sums the model group's
    gradients into each shard, which is the data-parallel sum over those
    ranks (every rank feeds its own rows). The module keeps empty
    placeholders for these names; callers run it through
    torch.func.functional_call with the gathered tensors."""

    def __init__(self, module: nn.Module, n_model: int, model_rank: int,
                 group=None, min_size: int = 2 ** 16):
        self.n_model, self.rank, self.group = n_model, model_rank, group
        self.shards, self.axes = {}, {}
        params = dict(module.named_parameters())
        for name, axis in param_shardings(module, n_model, min_size).items():
            if axis is None:
                continue
            p = params[name]
            self.axes[name] = axis
            self.shards[name] = nn.Parameter(self.block(name, p.detach()))
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def __contains__(self, name: str) -> bool:
        return name in self.shards

    def gather(self) -> dict:
        """{name: full weight}, differentiable into the shards."""
        from torch.distributed.nn.functional import all_gather
        return {name: torch.cat(all_gather(s, group=self.group),
                                dim=self.axes[name])
                for name, s in self.shards.items()}

    @torch.no_grad()
    def gather_full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A shard-shaped tensor of ``name`` (a moment, an accumulator)
        gathered into the full shape."""
        parts = [torch.empty_like(t) for _ in range(self.n_model)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=self.axes[name])

    def block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full tensor of ``name``."""
        return t.chunk(self.n_model, dim=self.axes[name])[self.rank].clone()


@dataclasses.dataclass
class StepMesh:
    """What a training step needs of the (data, model) mesh: the world's
    group (every process, each with its own rows), the model group that
    holds the shards and the data group of ranks holding the same shard.
    A step on one device without a process group takes no StepMesh and
    runs no collective."""
    world: int
    rank: int
    n_model: int = 1
    model_rank: int = 0
    model_group: object = None
    data_group: object = None

    @classmethod
    def from_mesh(cls, mesh) -> "StepMesh":
        world, rank = batch_sharding(mesh)
        return cls(world=world, rank=rank, n_model=mesh["model"].size(),
                   model_rank=mesh["model"].get_local_rank(),
                   model_group=mesh["model"].get_group(),
                   data_group=mesh["data"].get_group())

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank (no gradient): a loss's global
        denominator, or the global metrics."""
        t = t.detach().clone()
        dist.all_reduce(t)
        return t

    def sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank, differentiable (its backward
        sums the gradients over the ranks)."""
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(t)

    @torch.no_grad()
    def reduce_grads(self, grads: list, sharded: list) -> list:
        """Each gradient summed over the ranks that share its tensor: a
        replicated one over every rank, a shard's (already summed over its
        model group by the gather's backward) over the data group. One flat
        all-reduce per kind; the sums are views of its buffer."""
        out = list(grads)
        for group, pick in ((None, False), (self.data_group, True)):
            idx = [i for i, s in enumerate(sharded) if s == pick]
            if not idx or (pick and self.world == self.n_model):
                continue
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=group)
            for i, part in zip(idx, flat.split(
                    [grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return out

    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model group (no gradient)."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.model_group)
        return t
