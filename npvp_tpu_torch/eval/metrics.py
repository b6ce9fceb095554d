"""Quality metrics (port of ``npvp_tpu/eval/metrics.py``): PSNR with eps
1e-8, SSIM with an 11×11 σ = 1.5 Gaussian window (a grouped convolution
with zero padding 5, as JAX's ``SAME`` depthwise convolution), C1 = 0.01²,
C2 = 0.03², and MSE summed per sample, on channels-last (N, H, W, C) images
in [0, 1], in fp32; plus the per-future-timestep protocol."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def psnr(x, y, data_range: float = 1.0, mean_flag: bool = True):
    """(N, H, W, C) batch PSNR, −10·log10(mse + 1e-8)."""
    x, y = x.float() / data_range, y.float() / data_range
    score = -10.0 * torch.log10(((x - y) ** 2).mean(dim=(1, 2, 3)) + 1e-8)
    return score.mean() if mean_flag else score


def mse_score(x, y, mean_flag: bool = True):
    """Per-sample summed squared error."""
    mse = ((x.float() - y.float()) ** 2).sum(dim=(1, 2, 3))
    return mse.mean() if mean_flag else mse


def _gaussian_window(window_size: int, sigma: float) -> torch.Tensor:
    xs = torch.arange(window_size, dtype=torch.float32) - window_size // 2
    g = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5,
         mean_flag: bool = True):
    """(N, H, W, C) SSIM with a Gaussian window."""
    C = img1.shape[-1]
    win = _gaussian_window(window_size, sigma).to(img1.device)
    kernel = win.expand(C, 1, window_size, window_size)

    def conv(t):
        return F.conv2d(t.permute(0, 3, 1, 2), kernel,
                        padding=window_size // 2, groups=C)

    x, y = img1.float(), img2.float()
    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = conv(x * x) - mu1_sq
    sigma2_sq = conv(y * y) - mu2_sq
    sigma12 = conv(x * y) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean() if mean_flag else ssim_map.mean(dim=(1, 2, 3))


def to_unit_range(x, mean, std, device=None) -> torch.Tensor:
    """Model range → [0, 1]: ``clip(x·std + mean, 0, 1)`` in fp32 on
    ``device`` (``x``'s own by default), as the datasets' renormaliser."""
    x = torch.as_tensor(x, device=device).float()
    mean, std = (torch.as_tensor(v, dtype=torch.float32, device=x.device)
                 for v in (mean, std))
    return torch.clamp(x * std + mean, 0.0, 1.0)


def clip_metrics(pred, gt, mean, std) -> dict:
    """Per-sequence, per-timestep PSNR/SSIM/MSE of (N, T, H, W, C) clips in
    model range, in one batched pass over all T with the renormalisation
    (:func:`to_unit_range`) folded in → {"PSNR", "SSIM", "MSE"} of (N, T)
    tensors."""
    N, T = pred.shape[:2]

    def frames(x):
        x = to_unit_range(x, mean, std, pred.device)
        return x.reshape((N * T,) + x.shape[2:])

    p, g = frames(pred), frames(gt)
    return {name: fn(p, g, mean_flag=False).reshape(N, T)
            for name, fn in (("PSNR", psnr), ("SSIM", ssim),
                             ("MSE", mse_score))}


def pred_ave_metrics(predict_fn: Callable, data_loader, metric_fn: Callable,
                     renorm, num_future_frames: int) -> np.ndarray:
    """Per-future-timestep metric averaged over a test loader: prediction
    and ground truth renormalised to [0, 1] first; → an array of length
    ``num_future_frames``. ``predict_fn``: batch dict → (N, TP, H, W, C)
    predicted frames."""
    totals = np.zeros(num_future_frames)
    count = 0
    for batch in data_loader:
        pred = np.asarray(torch.as_tensor(predict_fn(batch)).float().cpu())
        future = np.asarray(batch["future"], np.float32)
        n = pred.shape[0]
        for t in range(num_future_frames):
            m = float(metric_fn(torch.from_numpy(renorm(pred[:, t])),
                                torch.from_numpy(renorm(future[:, t]))))
            totals[t] += m * n
        count += n
    return totals / max(count, 1)
