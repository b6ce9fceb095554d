"""Megatron tensor parallelism over the VidHRFormer's attention heads and
FFN hidden width (port of ``_TP_RULES``/``param_spec`` and the model-axis
guard of ``npvp_tpu/core/mesh.py:67-81,127-132``).

:data:`TP_RULES` maps the port's parameter names to the dimension that
the model axis splits, in the port's layouts (``nn.Linear.weight`` is
(out, in), the transpose of a flax kernel):

- ``wq``/``wk``/``wv`` and ``linear1``: column-parallel, split on the
  output rows of the weight, and their biases with them;
- ``wo`` and ``linear2``: row-parallel, split on the input columns; the
  bias is whole and added once, after the partial products are summed;
- everything else, MlpDWBN's ``fc1``/``fc2`` included, replicated (JAX's
  rules do not match them either).

:func:`shard_tensor_parallel` replaces those weights in place with this
rank's slice and gives the modules their model axis (``.tp``): an
attention keeps ``num_heads / model`` heads, a block's FFN ``hidden /
model`` of its width. As in JAX, a module whose heads or hidden width the
model axis does not divide stays whole. The weights stay plain tensors, so
the kernel and the affine-fused path read them as they are, and FSDP
shards the local slices over the data axis on top.

:class:`ParamShards` gathers a split state into the one-process layout
(checkpoints) and cuts a one-process state back into a rank's slices
(restores at any rank count).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from npvp_tpu_torch.core.distributed import MODEL_AXIS, AxisShard, axis

TP_RULES = (
    (re.compile(r"(.*\.)?(wq|wk|wv)\.(weight|bias)$"), 0),
    (re.compile(r"(.*\.)?wo\.weight$"), 1),
    (re.compile(r"(.*\.)?linear1\.(weight|bias)$"), 0),
    (re.compile(r"(.*\.)?linear2\.weight$"), 1),
)


def param_split(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` that the model axis splits, or
    None for a replicated one (before the divisibility guard)."""
    for pattern, dim in TP_RULES:
        if pattern.match(name):
            return dim
    return None


@dataclass
class ParamShards:
    """The split parameters of a module (``plan``: name → dimension) and
    the model axis they are split over."""

    plan: Dict[str, int] = field(default_factory=dict)
    model_axis: Optional[AxisShard] = None

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Tensor ``name`` of a state in the one-process layout: an FSDP
        shard gathered over the data axis, a tensor-parallel slice over the
        model axis (collectives: every rank calls it, in one order)."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t.full_tensor()
        dim = self.plan.get(name)
        if dim is None or self.model_axis is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.model_axis.size)]
        dist.all_gather(parts, t, group=self.model_axis.group)
        return torch.cat(parts, dim)

    def local(self, name: str, full: torch.Tensor,
              like: torch.Tensor) -> torch.Tensor:
        """``full`` (the one-process layout) cut as ``like`` holds it: this
        rank's tensor-parallel slice, then, for an FSDP parameter, its data
        shard."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        dim = self.plan.get(name)
        if dim is not None and self.model_axis is not None:
            full = full.chunk(self.model_axis.size, dim)[self.model_axis.rank]
        if isinstance(like, DTensor):
            return distribute_tensor(full.to(like.device, like.dtype),
                                     like.device_mesh, like.placements)
        return full


def _take(layer: nn.Linear, name: str, dim: int, shard: AxisShard) -> None:
    p = getattr(layer, name)
    piece = p.detach().chunk(shard.size, dim)[shard.rank].clone()
    setattr(layer, name, nn.Parameter(piece, requires_grad=p.requires_grad))


def tensor_parallel_plan(model: nn.Module, size: int) -> Dict[str, int]:
    """Parameter name → split dimension of :data:`TP_RULES` for a model
    axis of ``size``, after ``mesh.py``'s guard: an attention whose heads,
    or an FFN whose hidden width, ``size`` does not divide stays whole."""
    from npvp_tpu_torch.nn.layers import MultiHeadAttention
    from npvp_tpu_torch.nn.vidhrformer import VidHRFormerBlockEnc

    plan = {}
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention):
            if mod.num_heads % size:
                continue
            owned = ("wq", "wk", "wv", "wo")
        elif isinstance(mod, VidHRFormerBlockEnc):
            if mod.linear1.out_features % size:
                continue
            owned = ("linear1", "linear2")
        else:
            continue
        prefix = f"{name}." if name else ""
        for child in owned:
            for leaf, _ in getattr(mod, child).named_parameters():
                full = f"{prefix}{child}.{leaf}"
                if param_split(full) is not None:
                    plan[full] = param_split(full)
    return plan


def shard_tensor_parallel(model: nn.Module, mesh) -> ParamShards:
    """Split ``model``'s attention heads and FFN hidden widths over
    ``mesh``'s model axis (:func:`tensor_parallel_plan`), in place (before
    any optimizer holds its parameters, and before DDP or FSDP wraps it);
    → the split parameters. Nothing changes on a model axis of size 1.

    Raises for int8 execution (its per-row scales would be taken over a
    slice of the row) and, under the bf16 kernel (``exec_mode`` "pallas"),
    for an attention whose local heads the kernel cannot take (heads of
    64, at most 8 fused)."""
    from npvp_tpu_torch.kernels import temporal_attention as ta
    from npvp_tpu_torch.nn.layers import MultiHeadAttention

    shard = axis(mesh, MODEL_AXIS)
    if shard is None:
        return ParamShards()
    plan = tensor_parallel_plan(model, shard.size)
    split_modules = {name.rsplit(".", 2)[0] if name.count(".") > 1 else ""
                     for name in plan}
    for name, dim in plan.items():
        *path, child, leaf = name.split(".")
        layer = model.get_submodule(".".join(path + [child]))
        _take(layer, leaf, dim, shard)
        layer.in_features, layer.out_features = (layer.weight.shape[1],
                                                 layer.weight.shape[0])
    for name in split_modules:
        mod = model.get_submodule(name)
        if getattr(mod, "quant", False):
            raise ValueError("int8 execution is not tensor-parallel")
        mod.tp = shard
        if isinstance(mod, MultiHeadAttention):
            mod.num_heads //= shard.size
            _check_kernel_heads(model, mod, ta, shard.size)
    return ParamShards(plan, shard)


def _check_kernel_heads(model, mha, ta, model_size: int) -> None:
    if (getattr(model, "exec_mode", None) != "pallas"
            or mha.dtype != torch.bfloat16):
        return
    hd = mha.wq.out_features // mha.num_heads
    if not ta.takes(mha.wq.out_features, mha.num_heads, torch.bfloat16,
                    mha.wo.out_features):
        raise ValueError(
            f"model={model_size} leaves {mha.num_heads} heads of {hd} per "
            f"rank; the bf16 attention kernel takes heads of "
            f"{ta.HEAD_DIM_BF16} and at most {ta.MAX_FUSED_HEADS_BF16} of "
            "them fused")
