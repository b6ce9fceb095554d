"""The numerics that a kernel's plain twin and the modules' eager code share,
kept below both (``nn.layers`` re-exports them)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def reflect_pad_2d(x, pad: int):
    """Reflection-pad the (H, W) axes of an (..., H, W, C) tensor."""
    lead = x.shape[:-3]
    y = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
    y = F.pad(y, (pad, pad, pad, pad), mode="reflect").permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])
