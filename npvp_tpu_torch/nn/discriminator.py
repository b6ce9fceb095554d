"""PatchGAN discriminator and the adversarial losses (port of
``npvp_tpu/nn/discriminator.py``): the pix2pix PatchGAN, the vanilla /
lsgan / wgangp GAN loss and the WGAN-GP gradient penalty of the
reference's adversarial stage 2, which every shipped config leaves off
(``use_gan: False``).

Submodule names follow the flax module (``conv0`` … ``conv{n_layers}``,
``bn1`` … ``bn{n_layers}``, ``head``), so the weight bridge
(``npvp_tpu_torch.tools.weights``) maps its variables.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from npvp_tpu_torch.nn.layers import BatchNorm, conv_nhwc


class PatchDiscriminator(nn.Module):
    """70×70 PatchGAN over (N, H, W, C) frames → (N, h', w', 1) logits:
    4×4 convs at stride 2 and pad 1 with LeakyReLU(0.2), BatchNorm (flax's
    momentum-0.9 rule, ``nn.layers.BatchNorm``) after all but the first,
    a stride-1 4×4 conv and the 1-channel head. The module's mode is flax's
    ``train`` flag: in training mode the BatchNorms use and update batch
    statistics."""

    def __init__(self, in_channels: int = 1, ndf: int = 64,
                 n_layers: int = 3, dtype=torch.float32):
        super().__init__()
        self.n_layers, self.dtype = n_layers, dtype
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, 2, 1)
        prev = ndf
        for n in range(1, n_layers + 1):
            width = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv{n}", nn.Conv2d(prev, width, 4, stride, 1,
                                                  bias=False))
            self.add_module(f"bn{n}", BatchNorm(width, momentum=0.9,
                                                dtype=dtype))
            prev = width
        self.head = nn.Conv2d(prev, 1, 4, 1, 1)

    def forward(self, x):
        lrelu = lambda y: F.leaky_relu(y, 0.2)  # noqa: E731
        x = lrelu(conv_nhwc(x, self.conv0, self.dtype))
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"bn{n}")(conv_nhwc(
                x, getattr(self, f"conv{n}"), self.dtype))
            x = lrelu(x)
        return conv_nhwc(x, self.head, self.dtype)


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             mode: str = "vanilla", lam: float = 1.0) -> torch.Tensor:
    """vanilla (BCE with logits) / lsgan (MSE) / wgangp losses, in float32,
    times ``lam``."""
    logits = logits.float()
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        loss = torch.mean(torch.clamp(logits, min=0) - logits * target
                          + torch.log1p(torch.exp(-logits.abs())))
    elif mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        loss = torch.mean((logits - target) ** 2)
    elif mode == "wgangp":
        loss = -logits.mean() if target_is_real else logits.mean()
    else:
        raise ValueError(f"unknown gan mode {mode!r}")
    return lam * loss


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     t: torch.Tensor, lam_gp: float = 10.0,
                     lam_gan: float = 1.0) -> torch.Tensor:
    """WGAN-GP penalty on the interpolates ``t·real + (1 − t)·fake``, with
    ``t`` the (N, 1, …) uniform weights that the caller draws (JAX draws
    them from its key): mean((‖∇ critic‖ − 1)₊²) · lam_gp · lam_gan. The
    input gradient keeps its graph (``create_graph``), so the penalty is
    differentiable in the critic's parameters."""
    interp = t * real + (1.0 - t) * fake
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    grads, = torch.autograd.grad(critic_fn(interp).sum(), interp,
                                 create_graph=True)
    n = real.shape[0]
    gnorm = torch.sqrt((grads.reshape(n, -1).float() ** 2 + 1e-16).sum(1))
    penalty = torch.clamp(gnorm - 1.0, min=0.0)
    return (penalty ** 2).mean() * lam_gp * lam_gan
