"""Train state of the port: the step, the model, its optimizer and the
learning-rate schedule, updated in place (the JAX package threads an
immutable pytree, ``npvp_tpu/core/train_state.py``).

Under parallelism ``model`` is what a train step calls (a DDP wrapper, or
an FSDP module) and ``shards`` names the tensor-parallel slices; the
state dict is then gathered into the one-process layout (a collective:
every rank calls it) and a one-process state dict is cut back into this
rank's pieces, so that a checkpoint restores at any rank count."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from npvp_tpu_torch.core.distributed import unwrap
from npvp_tpu_torch.core.optim import Schedule, clip_subtree_by_global_norm
from npvp_tpu_torch.core.tensor_parallel import ParamShards
from npvp_tpu_torch.core.tracing import span


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    max_grad_norm: Optional[float] = None
    clip_predicate: Callable[[str], bool] = lambda name: False
    step: int = 0
    shards: Optional[ParamShards] = None
    # the clipped subtree's global norm at the last update (a 0-d tensor)
    grad_norm: Optional[torch.Tensor] = None

    @property
    def module(self) -> nn.Module:
        """The model itself, outside any DDP wrapper: what evaluation
        calls and what the state dict names."""
        return unwrap(self.model)

    def apply_gradients(self) -> None:
        """One update from the gradients in ``.grad``: the subtree clip,
        the rate of this step (the first update reads the schedule at 0, as
        optax does), the optimizer step, ``step += 1``, and the gradients
        cleared. A parameter that got no gradient gets zeros, as JAX gives
        it, so weight decay and the moments move it alike."""
        with span("npvp.train.optimizer"):
            params = list(self.module.named_parameters())
            for _, p in params:
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.max_grad_norm is not None:
                with span("npvp.train.clip"):
                    self.grad_norm = clip_subtree_by_global_norm(
                        params, self.max_grad_norm, self.clip_predicate,
                        self.shards)
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.step += 1

    def _param_names(self) -> list:
        """Parameter names by the optimizer's indices (the model's order)."""
        return [name for name, _ in self.module.named_parameters()]

    def state_dict(self) -> dict:
        model, opt = self.module.state_dict(), self.optimizer.state_dict()
        if self.shards is not None:
            full, names = self.shards.full, self._param_names()
            model = {k: full(k, v) for k, v in model.items()}
            opt["state"] = {i: {k: full(names[i], v) if _is_moment(v) else v
                                for k, v in st.items()}
                            for i, st in opt["state"].items()}
        return {"step": self.step, "model": model, "optimizer": opt}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        model, opt = state["model"], state["optimizer"]
        if self.shards is not None:
            local, names = self.shards.local, self._param_names()
            own = self.module.state_dict()
            params = dict(self.module.named_parameters())
            model = {k: local(k, v, own[k]) for k, v in model.items()}
            opt = dict(opt, state={
                i: {k: local(names[i], v, params[names[i]])
                    if _is_moment(v) else v for k, v in st.items()}
                for i, st in opt["state"].items()})
        self.module.load_state_dict(model)
        self.optimizer.load_state_dict(opt)


def _is_moment(v) -> bool:
    """An optimizer state entry shaped like its parameter (not the step)."""
    return isinstance(v, torch.Tensor) and v.dim() > 0


def param_count(model: nn.Module) -> int:
    """Trainable-parameter count."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
