"""Training losses (port of ``npvp_tpu/nn/losses.py``), in fp32: the
masked L1 and the two-Gaussian KL that stage 2 trains with, and the
reference's other exported losses (MSE with temporal weights, GDL, the
temporal difference and the bidirectional patch-NCE), which no trainer
calls."""

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


def mse_loss(pred, gt, temporal_weight: Optional[torch.Tensor] = None):
    """Mean squared error, optionally weighted per time step (axis 1)."""
    se = (pred.float() - gt.float()) ** 2
    if temporal_weight is not None:
        shape = [1] * se.dim()
        shape[1] = temporal_weight.shape[0]
        se = se * temporal_weight.reshape(shape)
    return se.mean()


def gdl_loss(pred, gt, alpha: float = 1.0):
    """Gradient-difference loss over (…, H, W, C) frames."""
    pred, gt = pred.float(), gt.float()
    d_gt_h = (gt[..., 1:, :, :] - gt[..., :-1, :, :]).abs()
    d_pr_h = (pred[..., 1:, :, :] - pred[..., :-1, :, :]).abs()
    d_gt_w = (gt[..., :, 1:, :] - gt[..., :, :-1, :]).abs()
    d_pr_w = (pred[..., :, 1:, :] - pred[..., :, :-1, :]).abs()
    g1, g2 = (d_gt_h - d_pr_h).abs(), (d_gt_w - d_pr_w).abs()
    if alpha != 1.0:
        g1, g2 = g1 ** alpha, g2 ** alpha
    return g1.mean() + g2.mean()


def temporal_diff_loss(pred, gt, shift: int, lam: float = 1.0):
    """Temporal-difference loss with an explicit roll ``shift`` along axis
    1 (the reference draws it at random per call)."""
    dp = pred - torch.roll(pred, shift, dims=1)
    dg = gt - torch.roll(gt, shift, dims=1)
    return lam * (dp.float() - dg.float()).abs().mean()


def bi_patch_nce_loss(gt_f, pred_f, temperature: float = 0.07,
                      lam: float = 1.0):
    """Bidirectional patchwise contrastive loss of (N, T, H, W, C)
    features: in each direction a position's positive is the other
    tensor's same position and its negatives the other positions, whose
    logits carry no gradient to the other tensor (JAX's stop_gradient)."""
    N, T, H, W, C = gt_f.shape
    gt = gt_f.reshape(N * T, H * W, C).float()
    pr = pred_f.reshape(N * T, H * W, C).float()
    eye = torch.eye(H * W, device=gt.device)[None]

    def direction(a, b):
        diag = torch.einsum("npc,nqc->npq", a, b) * eye
        nondiag = torch.einsum("npc,nqc->npq", a, b.detach()) * (1.0 - eye)
        logp = torch.log_softmax((diag + nondiag) / temperature, dim=-1)
        return -torch.diagonal(logp, dim1=1, dim2=2).mean()

    return lam * 0.5 * (direction(gt, pr) + direction(pr, gt))
