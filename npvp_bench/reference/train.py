"""Plain float32 reference of one stage-2 train step of the NPVP predictor
over a frozen autoencoder, in rand-context (masked) mode: AE encode of the
clip, the predictor in training mode on the full clip with the batch's
observed and target masks (dropout, DropPath and the posterior latent
drawn from the step's stream), AE decode of the predicted features, the
masked image L1 plus ``lam_PF_L1`` × the masked feature L1 plus β × the
KL of prior to posterior, the gradients, a clip of the decoder's
gradients to global norm ``max_grad_norm``, and AdamW(0.9, 0.999, eps
1e-8, weight decay 0.01) at the rate of cosine warm restarts.

The optimizer is written out from its equations (decoupled decay
``p ← p·(1 − lr·wd)``, then ``p ← p − lr·m̂ / (√v̂ + eps)`` with
bias-corrected moments), not taken from ``torch.optim``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from npvp_bench.reference.model import Rng, coordinate_grid


def l1(pred, gt, mask, lam: float = 1.0):
    """Mean |pred − gt| over the frames (axis 1) that ``mask`` keeps."""
    m = mask.float().reshape((1, -1) + (1,) * (pred.dim() - 2))
    n = torch.clamp(mask.float().sum(), min=1.0) * (
        pred.numel() / pred.shape[1])
    return lam * ((pred - gt).abs() * m).sum() / n


def kl(mu1, logvar1, mu2, logvar2, beta: float):
    """β · Σ KL(N(mu1, e^logvar1) ‖ N(mu2, e^logvar2)) / batch."""
    kld = (0.5 * (logvar2 - logvar1)
           + (torch.exp(logvar1) + (mu1 - mu2) ** 2)
           / (2.0 * torch.exp(logvar2)) - 0.5)
    return beta * kld.sum() / mu1.shape[0]


def cosine_lr(step: int, base: float, eta_min: float, cycle: int) -> float:
    frac = (step % cycle) / cycle
    return eta_min + 0.5 * (base - eta_min) * (1.0 + math.cos(math.pi * frac))


class Trainer:
    """The predictor's parameters, AdamW's moments and the step count;
    ``step(batch, seed)`` runs one update and returns the losses."""

    def __init__(self, config: dict, ae, predictor, steps_per_epoch: int):
        self.p = config["Predictor"]
        self.ae = ae.eval().requires_grad_(False)
        self.model = predictor.train()
        self.params = dict(predictor.named_parameters())
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.cycle = self.p["scheduler_T0"] * max(1, steps_per_epoch)
        self.grads: Dict[str, torch.Tensor] = {}

    def loss(self, batch, seed: int):
        p = self.p
        clip = batch["clip"]
        obs, tgt = batch["obs_mask"], batch["tgt_mask"]
        coords = coordinate_grid(range(p["max_T"]), p["max_T"], p["max_H"],
                                 p["max_W"], clip.device)
        with torch.no_grad():
            feats = self.ae.encode(clip)
        out = self.model(feats, coords, coords,
                         target_feats_gt=feats if p["stochastic"] else None,
                         obs_mask=obs, tgt_mask=tgt, rng=Rng(seed))
        frames = self.ae.decode(out.pred_features)
        losses = {"Image_L1": l1(frames, clip, tgt),
                  "PF_L1": l1(out.pred_features, feats, tgt,
                              p["lam_PF_L1"])}
        if p["stochastic"]:
            losses["KL_loss"] = kl(out.mu_o, out.logvar_o, out.mu_p,
                                   out.logvar_p, p["KL_beta"])
        losses["loss"] = sum(losses.values())
        return losses

    def step(self, batch, seed: int) -> Dict[str, float]:
        losses = self.loss(batch, seed)
        names = list(self.params)
        grads = torch.autograd.grad(losses["loss"],
                                    [self.params[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(self.params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        dec = [k for k in names if k.startswith("decoder.")]
        norm = torch.sqrt(sum((grads[k] ** 2).sum() for k in dec))
        scale = torch.clamp(self.p["max_grad_norm"]
                            / torch.clamp(norm, min=1e-12), max=1.0)
        for k in dec:
            grads[k] = grads[k] * scale
        self.grads = grads
        lr = cosine_lr(self.t, self.p["predictor_lr"],
                       self.p["scheduler_eta_min"], self.cycle)
        self.t += 1
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01
        with torch.no_grad():
            for k in names:
                g, w = grads[k], self.params[k]
                self.m[k].mul_(b1).add_((1 - b1) * g)
                self.v[k].mul_(b2).add_((1 - b2) * g * g)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                w.mul_(1 - lr * wd)
                w.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
        return {k: float(v.detach()) for k, v in losses.items()}
