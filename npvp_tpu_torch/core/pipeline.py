"""GPipe pipeline parallelism over a ("data", "pipe") mesh (port of
``npvp_tpu/core/pipeline.py``).

A stack of L identical blocks (the VidHRFormer decoder's ``layer_{i}``)
runs as S stages of L/S blocks, one stage per rank of the ``pipe`` axis,
over M microbatches: stage s works on microbatch m at tick s + m, so the
ticks run t = 0 … M + S − 2 and stage s is busy with microbatch t − s, JAX's
schedule. Each stage receives its input from stage s − 1 and sends its
output to stage s + 1 by point-to-point messages (a blocking receive
orders the ticks; no stage waits on a later one, so the chain cannot
deadlock), and the last stage's outputs are broadcast along ``pipe`` so
that every rank returns them, as JAX's masked psum does.

The contract is the forward (as in JAX's tests): it runs under
``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from npvp_tpu_torch.core.distributed import DATA_AXIS

PIPE_AXIS = "pipe"
# the dtypes a microbatch leaf may have, by their code in a message
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8)


def stack_layer_params(layers: Sequence[Union[nn.Module, Dict]]
                       ) -> Dict[str, torch.Tensor]:
    """L modules of one structure (or their state dicts) → one dict of
    their entries stacked along a new leading axis, name → (L, …)."""
    states = [m.state_dict() if isinstance(m, nn.Module) else m
              for m in layers]
    return {k: torch.stack([s[k].detach() for s in states])
            for k in states[0]}


def make_pipeline_mesh(stages: int, data: int = 1,
                       device_type: str = "cuda"):
    """The ("data", "pipe") ``DeviceMesh`` of the group's ``data · stages``
    ranks, ``pipe`` innermost (rank r is stage r % stages of data row
    r // stages), so that stage-to-stage messages take the nearest links."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n != data * stages:
        raise ValueError(f"a {data}x{stages} pipeline mesh needs "
                         f"{data * stages} ranks, the group has {n}")
    return init_device_mesh(device_type, (data, stages),
                            mesh_dim_names=(DATA_AXIS, PIPE_AXIS))


def _wire(group, device) -> torch.device:
    """Where a message's tensors travel: gloo moves CUDA tensors through
    host memory, NCCL takes them on their card."""
    return (torch.device("cpu") if dist.get_backend(group) == "gloo"
            else torch.device(device))


def _codes(tensors, n: int, device) -> torch.Tensor:
    if tensors is None:
        return torch.empty(n, dtype=torch.int64, device=device)
    return torch.tensor([_DTYPES.index(t.dtype) for t in tensors],
                        device=device)


def _send(tensors: List[torch.Tensor], dst: int, group) -> None:
    wire = _wire(group, tensors[0].device)
    for t in [_codes(tensors, 0, wire)] + tensors:
        dist.send(t.contiguous().to(wire), dst, group=group)


def _recv(like: List[torch.Tensor], src: int, group) -> List[torch.Tensor]:
    """Tensors shaped as ``like`` (their dtypes come in the message)."""
    wire = _wire(group, like[0].device)
    codes = _codes(None, len(like), wire)
    dist.recv(codes, src, group=group)
    out = []
    for t, code in zip(like, codes.tolist()):
        buf = torch.empty(t.shape, dtype=_DTYPES[code], device=wire)
        dist.recv(buf, src, group=group)
        out.append(buf.to(t.device))
    return out


def _broadcast(tensors: Optional[List[torch.Tensor]],
               like: List[torch.Tensor], src: int, group):
    """The source's ``tensors`` (shaped as ``like``) on every rank."""
    wire = _wire(group, like[0].device)
    codes = _codes(tensors, len(like), wire)
    dist.broadcast(codes, src, group=group)
    out = []
    for i, (t, code) in enumerate(zip(like, codes.tolist())):
        buf = (tensors[i].contiguous().to(wire) if tensors is not None else
               torch.empty(t.shape, dtype=_DTYPES[code], device=wire))
        dist.broadcast(buf, src, group=group)
        out.append(buf.to(t.device))
    return out


def _gather_data(x: torch.Tensor, group) -> torch.Tensor:
    """The data rows' (M, b, …) blocks side by side along dim 1."""
    y = x.contiguous().to(_wire(group, x.device))
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, 1).to(x.device)


def pipeline_apply(fn: Callable[[Dict[str, torch.Tensor], Any], Any],
                   stacked_params: Dict[str, torch.Tensor],
                   microbatches: Any, *, mesh, axis: str = PIPE_AXIS,
                   data_axis: Optional[str] = None) -> Any:
    """Apply an L-layer stack as an S-stage pipeline (S = the size of
    ``mesh``'s ``axis``).

    fn(layer_params, x) -> y     one block; x and y share a structure and
                                 shapes (``torch.func.functional_call`` of a
                                 block module, for example)
    stacked_params               name → (L, …) (:func:`stack_layer_params`);
                                 L % S == 0; this rank keeps its L/S layers
    microbatches                 a tensor or a tuple/list/dict of them, each
                                 (M, …): M microbatches

    Returns outputs shaped like ``microbatches`` on every rank: element m
    is fn(layer L-1, … fn(layer 0, microbatches[m])), the sequential
    stack. With ``data_axis`` every leaf's second dimension (the batch
    within a microbatch) is split over that axis in contiguous blocks:
    each (data, pipe) row pipelines its own block, and the rows' outputs
    are gathered at the end."""
    S, stage = mesh[axis].size(), mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    L = next(iter(stacked_params.values())).shape[0]
    if L % S:
        raise ValueError(f"{L} layers not divisible by {S} stages")
    per = L // S
    local = [{k: v[i].clone() for k, v in stacked_params.items()}
             for i in range(stage * per, (stage + 1) * per)]
    leaves, spec = tree_flatten(microbatches)
    if data_axis is not None:
        n, d = mesh[data_axis].size(), mesh.get_local_rank(data_axis)
        leaves = [x.tensor_split(n, 1)[d] for x in leaves]
    M = leaves[0].shape[0]
    rank_of = lambda s: dist.get_global_rank(group, s)  # noqa: E731
    outs = []
    with torch.no_grad():
        for m in range(M):  # tick stage + m
            h = ([x[m] for x in leaves] if stage == 0 else
                 _recv([x[m] for x in leaves], rank_of(stage - 1), group))
            tree = tree_unflatten(h, spec)
            for params in local:
                tree = fn(params, tree)
            h = tree_flatten(tree)[0]
            if stage < S - 1:
                _send(h, rank_of(stage + 1), group)
            else:
                outs.append(h)
        stacked = ([torch.stack(col) for col in zip(*outs)]
                   if stage == S - 1 else None)
        result = _broadcast(stacked, leaves, rank_of(S - 1), group)
        if data_axis is not None:
            result = [_gather_data(x, mesh.get_group(data_axis))
                      for x in result]
    return tree_unflatten(result, spec)
