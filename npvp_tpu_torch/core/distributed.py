"""Process groups, the (data, model) device mesh and the batch's split over
it (port of the mesh half of ``npvp_tpu/core/mesh.py`` and of
``maybe_init_distributed`` in ``npvp_tpu/train/common.py``).

One process drives one card. ``torchrun`` starts the processes and sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``PORT``;
:func:`maybe_init_distributed` joins them into a group (NCCL on the card,
gloo on the CPU or when asked), and :func:`make_mesh` lays the ranks out as
a ``DeviceMesh`` with axes ``("data", "model")``, ``model`` innermost as
in the JAX package: rank ``r`` is data index ``r // model`` and model
index ``r % model``.

The batch. ``Dataset.batch_size`` is the global batch, as on the JAX
package's mesh; each data rank holds ``batch_size / data`` of its rows, the
rows ``r, r + data, r + 2·data, …`` of data rank ``r``: the rows that the
loader's split ``idx[r::data]`` gives it (``npvp_tpu/data/loader.py:72``),
so a run on several ranks sees the one-process run's batches row for row.
:func:`shard_batch` cuts a global batch that way, :func:`gather_rows`
puts the rows back in order, and ``Rng.for_rows`` draws each row's noise
as the one-process run draws it.

Collectives that sit inside a model's forward and need a gradient are
``torch.autograd.Function`` s: :func:`all_reduce_sum` (sum forward, sum
backward: the global batch statistics of BatchNorm) and Megatron's pair
:func:`copy_to_model` / :func:`reduce_from_model` (identity forward with an
all-reduce backward, and the reverse) around tensor-parallel layers.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def maybe_init_distributed(device_type: str = "cuda",
                           backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> bool:
    """Join the process group and return True, or return False for a run
    of one process that no launcher started.

    Under ``torchrun`` the group comes from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``); a test passes ``init_method``
    (``file://…``), ``rank`` and ``world_size`` itself. The backend is NCCL
    for ``device_type`` "cuda" and gloo for "cpu", unless ``backend`` names
    one (gloo serves CUDA tensors too, for several ranks on one card). A
    group that already exists is kept as it is."""
    if dist.is_initialized():
        return True
    if init_method is None and "RANK" not in os.environ:
        return False
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    if init_method is None:  # torchrun's environment
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return True


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (0 without the variable)
    or the CPU when asked. Asked for CUDA without a card it raises, as
    ``core.device`` does."""
    from npvp_tpu_torch.core.device import resolve_device

    if device_type == "cpu":
        return resolve_device("cpu")
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def mesh_axis_sizes(n: int, data: int = -1, model: int = 1,
                    batch_size: Optional[int] = None) -> Tuple[int, int]:
    """The (data, model) sizes that ``npvp_tpu.core.mesh.make_mesh`` gives
    ``n`` devices: ``data=-1`` takes what ``model`` leaves, and a
    ``batch_size`` that the data axis does not divide clamps it to their
    gcd."""
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if batch_size is not None and batch_size % data:
        data = math.gcd(data, batch_size)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} devices")
    return data, model


def make_mesh(data: int = -1, model: int = 1,
              batch_size: Optional[int] = None,
              device_type: str = "cuda"):
    """The ``DeviceMesh`` of every rank of the group, axes ``("data",
    "model")``, sized by :func:`mesh_axis_sizes`. JAX leaves devices out of
    a clamped mesh; a rank has no such place, so a mesh that would leave
    ranks idle raises."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    d, m = mesh_axis_sizes(n, data, model, batch_size)
    if d * m != n:
        raise ValueError(
            f"mesh {d}x{m} (batch {batch_size}) leaves {n - d * m} of {n} "
            "ranks idle: start as many processes as the mesh has places")
    return init_device_mesh(device_type, (d, m),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


@dataclass(frozen=True)
class AxisShard:
    """One mesh axis as this rank sees it: the group, this rank's index on
    the axis and the axis's size."""

    group: Any
    rank: int
    size: int


def axis(mesh, name: str) -> Optional[AxisShard]:
    """``name``'s :class:`AxisShard` on ``mesh``; None without a mesh or on
    an axis of size 1 (nothing to split or reduce)."""
    if mesh is None or mesh[name].size() == 1:
        return None
    return AxisShard(mesh.get_group(name), mesh.get_local_rank(name),
                     mesh[name].size())


def is_main_process() -> bool:
    """Rank 0, or a run of one process: the one that logs and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _is_row_leaf(name: str, leaf) -> bool:
    """A leaf that ``shard_batch`` splits: not a mask, and batch-led (a
    (T,) mask is the same for every row; ``mesh.py:244-247``)."""
    return not name.endswith("_mask") and np.ndim(leaf) > 1


def shard_batch(mesh, batch):
    """This data rank's rows of a global batch (a dict of arrays or
    tensors, or one of them): rows ``r::data`` of every batch-led leaf;
    ``*_mask`` leaves and leaves of rank ≤ 1 replicated. The identity
    without a data axis."""
    shard = axis(mesh, DATA_AXIS)
    if shard is None:
        return batch
    cut = lambda x: x[shard.rank::shard.size]  # noqa: E731
    if isinstance(batch, dict):
        return {k: cut(v) if _is_row_leaf(k, v) else v
                for k, v in batch.items()}
    return cut(batch)


def gather_rows(mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global tensor from each data rank's rows ``r::data`` along
    ``dim`` (:func:`shard_batch`'s inverse), on every rank."""
    shard = axis(mesh, DATA_AXIS)
    if shard is None:
        return x
    x = x.contiguous()
    out = x.new_empty((shard.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=shard.group)
    # (ranks, ..., rows, ...) → (..., rows, ranks, ...) → global rows
    out = out.view((shard.size,) + tuple(x.shape)).movedim(0, dim + 1)
    return out.flatten(dim, dim + 1)


def all_mean(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, Any]:
    """Each metric (0-d tensors on one device) averaged over the data axis
    (the global batch's mean when every rank holds as many rows): one
    all-reduce for all of them."""
    shard = axis(mesh, DATA_AXIS)
    if shard is None or not metrics:
        return metrics
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vals, group=shard.group)
    return dict(zip(keys, (vals / shard.size).unbind(0)))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, shard: Optional[AxisShard]):
    """Σ of ``x`` over the axis, with the sum's gradient: the upstream
    gradients summed over the axis. ``x`` itself without an axis."""
    return x if shard is None else _AllReduceSum.apply(x, shard.group)


def copy_to_model(x: torch.Tensor, shard: Optional[AxisShard]):
    """The input of a column-parallel layer: ``x`` unchanged, its gradient
    summed over the model axis."""
    return x if shard is None else _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard: Optional[AxisShard]):
    """The output of a row-parallel layer: the partial products summed
    over the model axis; the gradient passes unchanged."""
    return x if shard is None else _ReduceFromModel.apply(x, shard.group)


def wrap_data_parallel(model: torch.nn.Module, mesh, fsdp: bool,
                       units=()) -> torch.nn.Module:
    """``model`` replicated over the data axis, for training: in DDP over
    the data group, or with ``fsdp`` fully sharded (FSDP2's
    ``fully_shard`` on the data sub-mesh) unit by unit, each of ``units``
    (the VidHRFormer blocks, the NP modules…) then the root. Apply
    tensor parallelism first: both see its local slices. DDP takes no
    buffers from rank 0 at each forward: the BatchNorms' statistics are
    the global batch's, equal on every rank.

    Returns the module to call in training. Evaluation calls the module
    itself (:func:`unwrap`), not DDP's forward: the attention kernel has no
    backward, and an eval step needs no gradient hooks."""
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        data_mesh = mesh[DATA_AXIS]
        # FSDP takes no 0-d parameter (the AE's attention gates): those stay
        # whole on every rank, their gradients averaged over the data axis
        scalars = {p for p in model.parameters() if p.dim() == 0}
        shard = axis(mesh, DATA_AXIS)
        for p in scalars:
            if shard is not None and p.requires_grad:
                p.register_post_accumulate_grad_hook(
                    lambda p: _average_grad(p, shard))
        for unit in units:
            fully_shard(unit, mesh=data_mesh, ignored_params=scalars)
        fully_shard(model, mesh=data_mesh, ignored_params=scalars)
        return model
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=None if dev.type == "cpu" else [dev],
        process_group=mesh.get_group(DATA_AXIS), broadcast_buffers=False)


def _average_grad(p: torch.nn.Parameter, shard: AxisShard) -> None:
    dist.all_reduce(p.grad, group=shard.group)
    p.grad.div_(shard.size)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a DDP wrapper (an FSDP module is its own)."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) \
        else model
