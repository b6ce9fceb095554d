"""Training losses of stage 2 (port of ``npvp_tpu/nn/losses.py``): the
masked L1 and the two-Gaussian KL, in fp32. The reference's other exported
losses (MSE, GDL, temporal difference, patch-NCE) are not ported yet."""

from __future__ import annotations

from typing import Optional

import torch


def l1_loss(pred, gt, lam: float = 1.0, mask: Optional[torch.Tensor] = None):
    """Mean absolute error × ``lam``. ``mask``: optional (T,) weights over
    axis 1 (masked-mode training); the mean is then taken over the masked
    frames only, with the denominator ``max(Σm, 1)·(size / T)``."""
    err = (pred.float() - gt.float()).abs()
    if mask is None:
        return lam * err.mean()
    m = mask.float()
    shape = [1] * err.dim()
    shape[1] = m.shape[0]
    denom = torch.clamp(m.sum(), min=1.0) * (err.numel() / err.shape[1])
    return lam * (err * m.reshape(shape)).sum() / denom


def kl_divergence(mu1, logvar1, mu2, logvar2, beta: float = 1.0):
    """β · Σ KL(N(μ1, σ1²) ‖ N(μ2, σ2²)) / batch; the trainer passes
    (prior, posterior)."""
    mu1, logvar1 = mu1.float(), logvar1.float()
    mu2, logvar2 = mu2.float(), logvar2.float()
    kld = (0.5 * (logvar2 - logvar1)
           + (torch.exp(logvar1) + (mu1 - mu2) ** 2)
           / (2.0 * torch.exp(logvar2)) - 0.5)
    return beta * kld.sum() / mu1.shape[0]
