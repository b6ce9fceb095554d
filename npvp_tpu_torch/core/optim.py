"""Optimizers and schedules (port of ``npvp_tpu/core/optim.py``).

- Stage 1 AE: Adam(lr, betas=(0.5, 0.999)).
- Stage 2 predictor: AdamW(0.9, 0.999, weight decay 0.01, eps 1e-8) with
  per-batch cosine warm restarts, after a clip by global norm of the
  NAR-decoder gradients only.

Schedules are functions of the optimizer step, counted from 0 at the first
update as optax counts them. ``torch.optim.AdamW`` applies the decay as
``p ← p − lr·wd·p`` beside the Adam step, which is optax's decoupled form.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

Schedule = Callable[[int], float]


def cosine_warm_restarts(base_lr: float, eta_min: float,
                         steps_per_cycle: int) -> Schedule:
    """CosineAnnealingWarmRestarts with T_mult = 1: the rate restarts at
    ``base_lr`` every ``steps_per_cycle`` steps."""
    def schedule(step: int) -> float:
        frac = (step % steps_per_cycle) / steps_per_cycle
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * frac))
    return schedule


def noam_schedule(model_size: int, factor: float,
                  warmup_steps: int) -> Schedule:
    """The warm-up/decay schedule of "Attention is all you need"."""
    def schedule(step: int) -> float:
        s = float(max(step, 1))
        return factor * model_size ** -0.5 * min(s ** -0.5,
                                                 s * warmup_steps ** -1.5)
    return schedule


def clip_subtree_by_global_norm(
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        max_norm: float, predicate: Callable[[str], bool],
        shards=None) -> torch.Tensor:
    """Scale, in place, the gradients of the parameters whose name satisfies
    ``predicate`` by ``min(1, max_norm / max(norm, 1e-12))``, where norm is
    the global norm of those gradients alone; the others pass unchanged.
    Returns the norm.

    The norm is the whole model's, the one-process norm, on every rank:
    FSDP's gradient shards (DTensors) are summed over the data axis, and
    with ``shards`` (``core.tensor_parallel.ParamShards``) the squares of a
    tensor-parallel slice are summed over the model axis while a replicated
    parameter counts once."""
    from torch.distributed.tensor import DTensor

    grads = [(name, p.grad) for name, p in named_params
             if predicate(name) and p.grad is not None]
    if not grads:
        return torch.zeros(())
    local = [g.to_local() if isinstance(g, DTensor) else g
             for _, g in grads]
    squares = [(g.float() ** 2).sum() for g in local]

    def reduce(picked, group):
        """Sum the squares of ``picked`` over ``group``, in one call."""
        if not picked:
            return
        total = torch.stack([squares[i] for i in picked])
        torch.distributed.all_reduce(total, group=group)
        for j, i in enumerate(picked):
            squares[i] = total[j]

    fsdp = [i for i, (_, g) in enumerate(grads) if isinstance(g, DTensor)]
    if fsdp:  # an FSDP shard's squares, over the data axis
        reduce(fsdp, grads[fsdp[0]][1].device_mesh.get_group())
    if shards is not None and shards.model_axis is not None:
        reduce([i for i, (name, _) in enumerate(grads)
                if name in shards.plan], shards.model_axis.group)
    norm = torch.sqrt(sum(squares))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in local:
        g.mul_(scale.to(g.dtype))
    return norm


def is_decoder_param(name: str) -> bool:
    """The parameters that the stage-2 clip covers: the NAR decoder's."""
    return name.startswith("decoder.")


def make_ae_optimizer(params, lr: float) -> torch.optim.Optimizer:
    """Adam(β1 = 0.5, β2 = 0.999): the pix2pix-style AE recipe."""
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8)


def make_predictor_optimizer(params, lr: float) -> torch.optim.Optimizer:
    """AdamW(0.9, 0.999, weight decay 0.01, eps 1e-8); its rate is set
    from the schedule before every step."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def predictor_schedule(lr: float, use_cosine: bool, eta_min: float,
                       steps_per_cycle: int) -> Schedule:
    if use_cosine:
        return cosine_warm_restarts(lr, eta_min, steps_per_cycle)
    return lambda step: lr
