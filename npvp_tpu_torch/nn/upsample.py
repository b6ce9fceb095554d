"""Sub-pixel (phase-decomposed) forms of two AE decoder convolutions (port of
``npvp_tpu/nn/upsample.py``). Each is the same function on the same
parameters as the convolution it stands for, computed as one dense
convolution with several output phases packed into channels, then a
depth-to-space interleave. Layouts are channels-last, (B, H, W, C); the
parameters are the port's ``nn.Conv2d`` / ``nn.ConvTranspose2d`` weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _depth_to_space(y, f: int):
    """(B, f²·O, h, w) with channel ``(r·f + c)·O + o`` → (B, f·h, f·w, O)
    with pixel (f·a + r, f·b + c)."""
    B, _, h, w = y.shape
    y = y.permute(0, 2, 3, 1).reshape(B, h, w, f, f, -1)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(B, f * h, f * w, -1)


def subpixel_conv_same(x, weight, bias=None, factor: int = 4):
    """The K×K stride-1 VALID convolution of ``x`` (B, Hp, Wp, I), an input
    already padded, by ``weight`` (O, I, K, K), as ONE stride-``factor``
    convolution whose factor² output phases are channels: the kernel of
    phase (r, c) is ``weight`` shifted by (r, c) inside a (K + f − 1)²
    window. The output side Hp − K + 1 must be a multiple of ``factor``.
    Returns (B, Hp − K + 1, Wp − K + 1, O)."""
    B, Hp, Wp, _ = x.shape
    K, f = weight.shape[-1], factor
    Ho, Wo = Hp - K + 1, Wp - K + 1
    if Ho % f or Wo % f:
        raise ValueError(f"output {Ho}x{Wo} is not a multiple of {f}")
    big = torch.cat([F.pad(weight, (c, f - 1 - c, r, f - 1 - r))
                     for r in range(f) for c in range(f)])
    # Ho / f windows of K + f - 1 at stride f span the padded input exactly
    y = F.conv2d(x.permute(0, 3, 1, 2), big.to(x.dtype),
                 None if bias is None else bias.to(x.dtype).repeat(f * f),
                 stride=f)
    return _depth_to_space(y, f)


def subpixel_conv_transpose_3x3_s2(x, weight):
    """``ConvTranspose2d(k3, s2, p1, output_padding=1)`` of ``x`` (B, H, W,
    I) by ``weight`` (I, O, 3, 3), as one 2×2 convolution with 4·O output
    channels: output pixel (2a + r, 2b + c) reads input pixels (a, b),
    (a, b + 1), (a + 1, b) and (a + 1, b + 1) only. Returns (B, 2H, 2W,
    O)."""
    k = lambda a, b: weight[:, :, a, b].t()  # noqa: E731  (O, I) tap
    z = torch.zeros_like(k(0, 0))
    # packed[phase][input tap (di, dj)], phases (0,0), (0,1), (1,0), (1,1)
    taps = [[k(1, 1), z, z, z],
            [k(1, 2), k(1, 0), z, z],
            [k(2, 1), z, k(0, 1), z],
            [k(2, 2), k(2, 0), k(0, 2), k(0, 0)]]
    packed = torch.cat([torch.stack(t, -1).reshape(t[0].shape + (2, 2))
                        for t in taps])  # (4·O, I, 2, 2)
    xp = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
    return _depth_to_space(F.conv2d(xp, packed.to(x.dtype)), 2)
