"""The numerics that a kernel's plain twin and the modules' eager code share,
kept below both (``nn.layers`` re-exports them)."""

from __future__ import annotations

import torch


def fp32_moments(x, dims, keepdim: bool = True):
    """(mean, var) over ``dims`` in float32, var as E[x²] − E[x]² clamped at
    0 — the form every norm and affine-statistics site of the JAX package
    shares, so the affine and generic attention paths agree."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=keepdim)
    mean_sq = (xf * xf).mean(dim=dims, keepdim=keepdim)
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


def softmax_f32_stats(logits, dims):
    """Softmax reading and writing ``logits`` in its own dtype with fp32
    exponent and sum (the subtraction of the max happens in that dtype): the
    AE's non-local attentions, whose logits are unscaled."""
    lmax = logits.amax(dim=dims, keepdim=True)
    e = torch.exp((logits - lmax).float())
    return (e / e.sum(dim=dims, keepdim=True)).to(logits.dtype)
