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
        max_norm: float, predicate: Callable[[str], bool]) -> torch.Tensor:
    """Scale, in place, the gradients of the parameters whose name satisfies
    ``predicate`` by ``min(1, max_norm / max(norm, 1e-12))``, where norm is
    the global norm of those gradients alone; the others pass unchanged.
    Returns the norm."""
    grads = [p.grad for name, p in named_params
             if predicate(name) and p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
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
