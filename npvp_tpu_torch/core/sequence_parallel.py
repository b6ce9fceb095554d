"""Sequence parallelism: the (N, T, H, W, C) activations of the VidHRFormer
stacks split on H over the mesh's model axis (port of
``sequence_parallel``, ``enable_sequence_parallel`` and ``sp_shard`` of
``npvp_tpu/core/mesh.py:160-222``).

    with sequence_parallel(mesh):
        out = predictor(...)            # and, in training, loss.backward()

or, for the life of the process, ``enable_sequence_parallel(mesh)`` (the
trainers call it from ``train.common.setup`` when ``Env.sequence_parallel``
is set). The stacks read the setting at each forward: a stack whose H the
model axis divides splits its input's rows over the model ranks, runs its
blocks on the shards and returns the whole output; any other runs whole,
as JAX constrains an axis only when the mesh axis divides it.

XLA inserted JAX's collectives from sharding constraints; here they are
written by hand, in Megatron-SP's layout on the model axis that tensor
parallelism already splits the heads and the FFN width over:

- each attention sublayer and the linear FFN gathers H at its input
  (:func:`gather_h`) and runs on its local heads or hidden slice; its
  output, a partial sum over the model ranks, is reduce-scattered back to
  H shards (:func:`reduce_scatter_h`) and its bias added there. A sublayer
  that tensor parallelism left whole runs whole on every rank and keeps
  its own rows (:func:`split_h`). Window attention thus sees whole windows
  whatever rows a shard holds, and the positional fusion and the affine
  path's frame statistics see whole frames;
- the TokenLayerNorms, MlpDWBN, residuals, dropout and DropPath run on the
  shards. MlpDWBN's depthwise 3×3 conv takes a one-row halo from each
  neighbouring rank (:func:`halo_rows`; zero rows at the global top and
  bottom), its (H, W, C) LayerNorms sum (Σx, Σx², count) per sample over
  the model ranks (``core.distributed.all_reduce_sum``) and use their own
  rows of the affine;
- a replicated parameter used on a shard gets a partial gradient on each
  rank: :func:`sp_param` sums it over the model axis in the backward pass,
  so the ranks' parameters stay equal;
- elementwise dropout on a shard keeps its rows of the one-process mask
  (``nn.layers.Rng``'s split draw), and DropPath's per-sample mask is the
  same on every shard of a sample.

Every collective is a ``torch.autograd.Function``: the all-gather's
backward takes this rank's rows of the (whole, equal on every rank)
gradient, the reduce-scatter's backward is an all-gather. Each runs in a
``torch.profiler`` span named ``sequence_parallel.<kind>`` (``gather_h``,
``split_h``, ``reduce_scatter_h``, ``halo``, ``norm_stats``), so that a
profile attributes their time.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from npvp_tpu_torch.core.distributed import (MODEL_AXIS, AxisShard, axis,
                                             copy_to_model)

H_DIM = 2  # H in the stacks' (N, T, H, W, C) activations

_SP_MESH = None


@contextlib.contextmanager
def sequence_parallel(mesh):
    """Split the stacks' activations on H over ``mesh``'s model axis for
    the forwards (and, in training, the backward passes: ``remat``
    recomputes a block there) run inside the context."""
    global _SP_MESH
    prev, _SP_MESH = _SP_MESH, mesh
    try:
        yield
    finally:
        _SP_MESH = prev


def enable_sequence_parallel(mesh) -> None:
    """The process-lifetime form of :func:`sequence_parallel`; None turns it
    off."""
    global _SP_MESH
    _SP_MESH = mesh


def sp_axis(x: torch.Tensor) -> Optional[AxisShard]:
    """The model axis over which a stack splits ``x``'s H (dim 2), or None:
    outside the context, on a model axis of size 1, or when the axis does
    not divide H."""
    shard = axis(_SP_MESH, MODEL_AXIS)
    if shard is None or x.dim() < 3 or x.shape[H_DIM] % shard.size:
        return None
    return shard


def _rows(x: torch.Tensor, shard: AxisShard, dim: int = H_DIM):
    n = x.shape[dim] // shard.size
    return x.narrow(dim, shard.rank * n, n)


def span(kind: str):
    """The profiler span of one of this module's collectives."""
    return record_function(f"sequence_parallel.{kind}")


def _all_gather(x: torch.Tensor, shard: AxisShard,
                kind: str) -> torch.Tensor:
    """(ranks, *x.shape): every rank's ``x``, in rank order."""
    x = x.contiguous()
    out = x.new_empty((shard.size * x.shape[0],) + tuple(x.shape[1:]))
    with span(kind):
        dist.all_gather_into_tensor(out, x, group=shard.group)
    return out.view((shard.size,) + tuple(x.shape))


def _gather_dim(x: torch.Tensor, shard: AxisShard, dim: int,
                kind: str) -> torch.Tensor:
    out = _all_gather(x, shard, kind).movedim(0, dim)
    return out.flatten(dim, dim + 1)


class _GatherH(torch.autograd.Function):
    """All-gather of H forward; this rank's rows of the gradient backward
    (the gathered tensor's consumers leave the whole gradient on every
    rank)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _gather_dim(x, shard, H_DIM, "gather_h")

    @staticmethod
    def backward(ctx, grad):
        return _rows(grad, ctx.shard).contiguous(), None


class _SplitH(torch.autograd.Function):
    """This rank's rows forward; the all-gather of their gradients
    backward (the whole input was computed alike on every rank)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _rows(x, shard).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.shard, H_DIM, "split_h"), None


def _reduce_scatter_by_all_reduce(x: torch.Tensor,
                                  shard: AxisShard) -> torch.Tensor:
    """gloo's form: the whole sum, then this rank's rows."""
    x = x.clone()
    with span("reduce_scatter_h"):
        dist.all_reduce(x, group=shard.group)
    return _rows(x, shard).contiguous()


def _reduce_scatter_rows(x: torch.Tensor, shard: AxisShard) -> torch.Tensor:
    """NCCL's form: each rank's rows of H as the chunk it receives."""
    parts = x.unflatten(H_DIM, (shard.size, -1)).movedim(H_DIM, 0)
    out = x.new_empty(parts.shape[1:])
    with span("reduce_scatter_h"):  # rank r's chunk: the r-th rows
        dist.reduce_scatter_tensor(out, parts.contiguous().flatten(0, 1),
                                   group=shard.group)
    return out


class _ReduceScatterH(torch.autograd.Function):
    """Σ over the model ranks, this rank's rows kept, forward; the
    all-gather of the gradient backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        if dist.get_backend(shard.group) == "gloo":
            return _reduce_scatter_by_all_reduce(x, shard)
        return _reduce_scatter_rows(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.shard, H_DIM, "reduce_scatter_h"), None


class _HaloRows(torch.autograd.Function):
    """(B, h, W, C) → (B, h + 2, W, C): the neighbouring ranks' edge rows
    above and below (zeros at the global edges). Backward, each halo row's
    gradient goes back to its owner and is added to its edge row."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        edges = _all_gather(torch.stack([x[:, 0], x[:, -1]]), shard, "halo")
        r, zero = shard.rank, torch.zeros_like(x[:, :1])
        top = edges[r - 1, 1][:, None] if r > 0 else zero
        bottom = edges[r + 1, 0][:, None] if r < shard.size - 1 else zero
        return torch.cat([top, x, bottom], dim=1)

    @staticmethod
    def backward(ctx, grad):
        shard, r = ctx.shard, ctx.shard.rank
        sent = _all_gather(torch.stack([grad[:, 0], grad[:, -1]]), shard,
                           "halo")
        out = grad[:, 1:-1].clone()
        if r > 0:  # rank r - 1's bottom halo is this rank's first row
            out[:, 0] += sent[r - 1, 1]
        if r < shard.size - 1:
            out[:, -1] += sent[r + 1, 0]
        return out, None


def gather_h(x: torch.Tensor, sp: Optional[AxisShard]) -> torch.Tensor:
    """The whole (…, H, …) tensor from every rank's rows (H at dim 2)."""
    return x if sp is None else _GatherH.apply(x, sp)


def split_h(x: torch.Tensor, sp: Optional[AxisShard]) -> torch.Tensor:
    """This rank's rows of a whole tensor that every rank holds alike."""
    return x if sp is None else _SplitH.apply(x, sp)


def reduce_scatter_h(x: torch.Tensor,
                     sp: Optional[AxisShard]) -> torch.Tensor:
    """This rank's rows of the sum of the ranks' whole partial tensors."""
    return x if sp is None else _ReduceScatterH.apply(x, sp)


def halo_rows(x: torch.Tensor, sp: AxisShard) -> torch.Tensor:
    """A (B, h, W, C) shard with one row of each neighbour above and below
    (zeros at the top and bottom of the whole tensor): the input of a
    3×3 convolution that pads nothing on H."""
    return _HaloRows.apply(x, sp)


def sp_param(p: torch.Tensor, sp: Optional[AxisShard]) -> torch.Tensor:
    """A replicated parameter as a shard uses it: unchanged forward, its
    gradient summed over the model axis backward."""
    return copy_to_model(p, sp)


def h_split(sp: Optional[AxisShard], dim: int = H_DIM):
    """The ``(dim, index, count)`` split of an H shard for ``nn.layers
    .Rng`` draws; None without sequence parallelism."""
    return None if sp is None else (dim, sp.rank, sp.size)
