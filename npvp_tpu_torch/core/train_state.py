"""Train state of the port: the step, the model, its optimizer and the
learning-rate schedule, updated in place (the JAX package threads an
immutable pytree, ``npvp_tpu/core/train_state.py``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from npvp_tpu_torch.core.optim import Schedule, clip_subtree_by_global_norm


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    max_grad_norm: Optional[float] = None
    clip_predicate: Callable[[str], bool] = lambda name: False
    step: int = 0

    def apply_gradients(self) -> None:
        """One update from the gradients in ``.grad``: the subtree clip,
        the rate of this step (the first update reads the schedule at 0, as
        optax does), the optimizer step, ``step += 1``, and the gradients
        cleared. A parameter that got no gradient gets zeros, as JAX gives
        it, so weight decay and the moments move it alike."""
        params = list(self.model.named_parameters())
        for _, p in params:
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_grad_norm is not None:
            clip_subtree_by_global_norm(params, self.max_grad_norm,
                                        self.clip_predicate)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])


def param_count(model: nn.Module) -> int:
    """Trainable-parameter count."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
