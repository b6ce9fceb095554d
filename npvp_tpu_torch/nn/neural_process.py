"""Neural-process conditioning (port of ``npvp_tpu/nn/neural_process.py``):
the Fourier-feature coordinate MLP, the parameter-free positional fusion and
the latent event encoder.

Flax draws the stochastic latent's noise from its ``"latent"`` rng, which
torch cannot reproduce; here the caller passes the noise ``eps`` in (or
none, which takes the mean, as ``sample=False`` does in flax). In training
mode the EventEncoder's BatchNorms use and update batch statistics, as flax
does with ``train=True``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from npvp_tpu_torch.nn.layers import (ConvBNAct, conv_nhwc, fp32_moments,
                                      linear)


class NRMLP(nn.Module):
    """Coordinates (M, dim_x) in [0, 1] → (beta, gamma), each
    (M, out_channels): [cos(2π·x·Bᵀ), sin(2π·x·Bᵀ)] through an MLP, with a
    trainable Gaussian B. ``fuse_method='Add'`` returns gamma = 0."""

    def __init__(self, out_channels: int, dim_x: int = 3, d_model: int = 256,
                 mlp_layers: int = 4, scale: float = 10.0,
                 fuse_method: str = "SPADE", dtype=torch.float32):
        super().__init__()
        self.fuse_method, self.dtype, self.scale = fuse_method, dtype, scale
        self.mlp_layers = mlp_layers
        self.B = nn.Parameter(torch.randn(d_model, dim_x) * scale)
        self.mlp_0 = nn.Linear(2 * d_model, d_model)
        for i in range(mlp_layers - 2):
            self.add_module(f"mlp_{i + 1}", nn.Linear(d_model, d_model))
        self.mlp_beta = nn.Linear(d_model, out_channels)
        if fuse_method == "SPADE":
            self.mlp_gamma = nn.Linear(d_model, out_channels)

    def forward(self, coords):
        proj = (2.0 * math.pi * coords.float()) @ self.B.t()
        x = torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)
        x = torch.relu(linear(x, self.mlp_0, self.dtype))
        for i in range(self.mlp_layers - 2):
            x = torch.relu(linear(x, getattr(self, f"mlp_{i + 1}"),
                                  self.dtype))
        beta = linear(x, self.mlp_beta, self.dtype)
        if self.fuse_method == "SPADE":
            return beta, linear(x, self.mlp_gamma, self.dtype)
        return beta, torch.zeros_like(beta)


def pos_feat_fuse(x, pos_beta, pos_gamma, norm_type: str = "layer",
                  eps: float = 1e-5):
    """Parameter-free SPADE-style fusion of (N, T, H, W, C) features with
    (T*H*W, C) modulation: ``norm(x)·(1 + gamma) + beta``."""
    N, T, H, W, C = x.shape
    dims = {"layer": (2, 3, 4), "instance": (2, 3),
            "batch": (0, 1, 2, 3), "syncbatch": (0, 1, 2, 3)}.get(norm_type)
    if dims is None:
        raise ValueError(f"unknown param-free norm type {norm_type!r}")
    mean, var = fp32_moments(x, dims)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    mean = mean.to(x.dtype)
    gamma = pos_gamma.reshape(T, H, W, C)[None].to(x.dtype)
    beta = pos_beta.reshape(T, H, W, C)[None].to(x.dtype)
    return (x - mean) * inv * (1.0 + gamma) + beta


class EventEncoder(nn.Module):
    """Event coding (N, H, W, C) → latent mean, and for the stochastic
    variant log-variance and a sample ``z = mu + exp(logvar/2)·eps``."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 n_layers: int = 1, stochastic: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.n_layers, self.stochastic, self.dtype = (n_layers, stochastic,
                                                      dtype)
        self.conv1 = ConvBNAct(in_channels, in_channels, 3,
                               groups=in_channels, dtype=dtype)
        self.conv2 = ConvBNAct(in_channels, hidden_channels, 3, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"mlp_{i}", ConvBNAct(
                hidden_channels, hidden_channels, 1, dtype=dtype))
        self.mu_net = nn.Conv2d(hidden_channels, in_channels, 1)
        if stochastic:
            self.logvar_net = nn.Conv2d(hidden_channels, in_channels, 1)

    def forward(self, x, eps=None):
        """Returns mu (deterministic), else (z, mu, logvar); ``eps`` is
        float32 noise of mu's shape, or None for z = mu."""
        x = self.conv2(self.conv1(x))
        for i in range(self.n_layers):
            x = getattr(self, f"mlp_{i}")(x)
        mu = conv_nhwc(x, self.mu_net, self.dtype)
        if not self.stochastic:
            return mu
        logvar = conv_nhwc(x, self.logvar_net, self.dtype)
        if eps is None:
            return mu, mu, logvar
        z = mu + torch.exp(0.5 * logvar.float()) * eps
        return z.to(self.dtype), mu, logvar
